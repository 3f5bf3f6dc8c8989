"""The reference's GSPMD train step on a (2, 2) ("data", "model") mesh of
four forced host devices, run in a subprocess for the port's
tensor-parallel and expert-parallel tests (no JAX in this process).

`run_reference` dumps to an ``.npz``, for each case: the initial params,
each step's loss, grad norm and gathered gradients, the final state and
each device's ``addressable_shards`` of it, at f32 compute, 2
microbatches, ``steps`` steps, AdamW at ``eps`` with a clip of 0.5.
`start_script` starts another script on the same devices.
"""
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REFERENCE = """
import sys
import numpy as np, jax
from repro.dist import compat
import repro.configs as C
from repro.data.synthetic import SyntheticStream, device_batch
from repro.dist.sharding import ShardingRules
from repro.optim import OptimizerConfig
from repro.train.step import build_train_step, make_train_state

out = {}
OPT = OptimizerConfig(lr=1e-3, eps=%r, grad_clip=0.5)
m = compat.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(compat.AxisType.Auto,) * 2)
assert [d.id for d in m.devices.flat] == [0, 1, 2, 3]
for tag, (arch, over) in %r.items():
    cfg = C.get(arch).reduced(compute_dtype="float32", microbatches=2,
                              **over)
    rules = ShardingRules(m, fsdp=cfg.fsdp)
    state = make_train_state(jax.random.PRNGKey(0), cfg, rules)
    for k, v in state.params.items():
        out[f"{tag}/init/{k}"] = np.asarray(v)
    step = jax.jit(build_train_step(cfg, m, rules, OPT, lambda s: 1e-3))
    stream = SyntheticStream(cfg, 16, 16, seed=0)
    with m:
        for t in range(%d):
            state, met, g = step(state, device_batch(stream.batch_at(t),
                                                     rules))
            out[f"{tag}/loss/{t}"] = np.asarray(met["loss"])
            out[f"{tag}/gnorm/{t}"] = np.asarray(met["grad_norm"])
            for k, v in g.items():
                out[f"{tag}/grad/{t}/{k}"] = np.asarray(v)
    for tree in ("params", "mu", "nu"):
        for k, v in getattr(state, tree).items():
            out[f"{tag}/{tree}/{k}"] = np.asarray(v)
            for s in v.addressable_shards:
                out[f"{tag}/shard/{tree}/{k}/{s.device.id}"] = \\
                    np.asarray(s.data)
np.savez(sys.argv[1], **out)
"""


def _env() -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_reference(path: str, cases: dict, eps: float, steps: int) -> str:
    """The reference's run of ``cases`` ({tag: (arch, overrides of
    .reduced())}) dumped to ``path``; returns ``path``."""
    out = subprocess.run(
        [sys.executable, "-c",
         textwrap.dedent(REFERENCE % (eps, cases, steps)), path],
        capture_output=True, text=True, env=_env(), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return path


def start_script(script: str, *args: str) -> subprocess.Popen:
    """``script`` started in a subprocess on the same four forced host
    devices, with ``args`` as its ``sys.argv[1:]`` (the caller waits)."""
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(script),
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env())
