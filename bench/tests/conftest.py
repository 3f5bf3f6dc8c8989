"""Shared set-up of the benchmark's tests: the repo and the port on the
path, the ``chip`` marker, and a tiny cell that runs on the CPU."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
            head_dim=16, d_ff=128, vocab_size=256)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips where there is none")


def tiny_cell(name="gpt2-1.5b.checkmate", compute_dtype="float32",
              **traffic):
    """The cell ``name`` cut to a CPU size: the model at ``TINY``'s
    widths in ``compute_dtype``, 4 rows of 16 tokens in 2 microbatches
    (``traffic`` overrides), the limits tight enough for f32."""
    from bench import spec
    from repro_torch import configs
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(TINY, compute_dtype=compute_dtype)
    if cfg["model"]["family"] == "vit":
        cfg["model"]["num_patches"] = 8
    base = configs.get(cfg["registry"])
    cfg["changed"] = {k: v for k, v in cfg["model"].items()
                      if getattr(base, k) != v}
    cell.config = cfg
    seq = 8 if cfg["model"]["family"] == "vit" else 16
    cell.traffic = dict(cell.traffic, batch=4, seq=seq, microbatches=2,
                        **traffic)
    cell.limits = {k: (0 if k == "shadow_mismatch" else 1e-4)
                   for k in cell.limits}
    return cell


@pytest.fixture
def chip():
    """Skip unless a CUDA device is present (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the chip")
