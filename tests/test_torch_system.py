"""The port's main path end to end on the CPU (plain versions of the
kernels): Checkmate's checkpoint equals the trainer bit for bit, recovery
replays the identical run, the loss trajectory follows the JAX package's,
and the port stands alone (no JAX, nothing of ``repro``).

Tolerance against JAX: losses to rtol 1e-4 at f32 compute (the two
frameworks sum in other orders; AdamW's ``b1 ** step`` is taken on the host
in the port). Inside the port: bitwise.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import repro.configs as C
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.optim import OptimizerConfig as JOpt
from repro.train.loop import train as jtrain
from repro.train.step import make_train_state as j_make_state

from repro_torch import configs as TC
from repro_torch.convert import state_from_numpy, to_numpy
from repro_torch.core.channel import InProcessChannel
from repro_torch.core.recovery import (FailurePlan, checkpoint_from_state,
                                       recover, state_from_checkpoint)
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_state

torch.set_num_threads(2)   # leave cores to the other test workers

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _cfg(**over):
    return TC.get("tinyllama-1.1b").reduced(**over)


def _trees_equal(ckpt: dict, state) -> bool:
    return all(torch.equal(ckpt[t][k], getattr(state, t)[k])
               for t in ("params", "mu", "nu")
               for k in getattr(state, t))


@pytest.mark.parametrize("async_mode", [False, True])
def test_checkpoint_is_bitwise_the_trainer(async_mode):
    state, stats = train(_cfg(microbatches=2), steps=4, batch=4, seq=32,
                         channel=InProcessChannel(), shadow_nodes=2,
                         shadow_async=async_mode, device="cpu")
    shadow = stats.checkpointer.shadow
    ckpt = shadow.consolidate(timeout=30)
    shadow.shutdown()
    assert ckpt["step"] == state.step == 4
    assert stats.checkpointer.n_checkpoints == 4
    assert _trees_equal(ckpt, state)
    assert shadow.stats().lag == 0


def test_failure_recovery_replays_the_identical_run():
    """The port's twin of examples/failure_recovery.py: a failure at step 3
    recovers from the shadow and ends where the unbroken run ends."""
    cfg = _cfg()
    ref_state, ref = train(cfg, steps=6, batch=4, seq=32, seed=7,
                           channel=InProcessChannel(), device="cpu")
    state, stats = train(cfg, steps=6, batch=4, seq=32, seed=7,
                         channel=InProcessChannel(), shadow_async=True,
                         failure_plan=FailurePlan((3,)), device="cpu")
    stats.checkpointer.shadow.shutdown()
    assert stats.failures == stats.recoveries == 1
    assert stats.recovered_at == [2]
    assert stats.losses == ref.losses
    for k, t in ref_state.params.items():
        assert torch.equal(state.params[k], t)


def test_recover_rebuilds_the_state_at_the_shadows_step():
    state, stats = train(_cfg(), steps=2, batch=2, seq=16,
                         channel=InProcessChannel(), device="cpu")
    rebuilt, step = recover(stats.checkpointer.shadow, device="cpu")
    assert step == 2 and rebuilt.step == 2
    for k, t in state.params.items():
        assert torch.equal(rebuilt.params[k], t)
        assert rebuilt.params[k].data_ptr() != t.data_ptr()
    again = state_from_checkpoint(checkpoint_from_state(rebuilt), "cpu")
    assert all(torch.equal(again.nu[k], t) for k, t in rebuilt.nu.items())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_loss_trajectory_matches_jax_train(microbatches):
    over = dict(compute_dtype="float32", microbatches=microbatches)
    jcfg = C.get("tinyllama-1.1b").reduced(**over)
    rules = ShardingRules(make_smoke_mesh())
    jstate = j_make_state(jax.random.PRNGKey(0), jcfg, rules)
    tstate = state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()},
        {k: np.asarray(v) for k, v in jstate.mu.items()},
        {k: np.asarray(v) for k, v in jstate.nu.items()}, 0, device="cpu")
    _, jstats = jtrain(jcfg, rules, steps=3, batch=4, seq=32, opt=JOpt(),
                       state=jstate)
    tstate, tstats = train(_cfg(**over), steps=3, batch=4, seq=32,
                           opt=OptimizerConfig(), state=tstate, device="cpu")
    np.testing.assert_allclose(tstats.losses, jstats.losses, rtol=1e-4)
    assert tstate.step == 3


def test_grad_clip_scale_reaches_the_shadow():
    opt = OptimizerConfig(grad_clip=0.05)
    state, stats = train(_cfg(), steps=3, batch=2, seq=16, opt=opt,
                         channel=InProcessChannel(), device="cpu")
    ckpt = stats.checkpointer.shadow.consolidate()
    assert _trees_equal(ckpt, state)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    # the walk reaches the harness and elastic modules too, and the
    # benchmark and example twins, which copy what they need of the root
    # ``benchmarks`` and ``examples`` packages
    assert {PORT / "harness" / f"{m}.py" for m in (
        "scenario", "corpus", "invariants", "runner", "__main__")} | {
        PORT / "core" / "elastic.py", PORT / "launch" / "roofline.py"} | {
        PORT / "benchmarks" / f"{m}.py" for m in (
            "common", "run", "savings", "multicast_overhead", "fabric_sweep",
            "kernels", "optimizer_scaling", "stalls", "throughput",
            "shadow_timing", "durability_timing", "correctness")} | {
        PORT / "examples" / f"{m}.py" for m in (
            "quickstart", "failure_recovery", "fabric_failures",
            "cost_planner", "serve_decode", "train_100m")} <= set(files)
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks",
                               "examples"), (f, name)


def test_port_runs_with_jax_and_repro_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "sys.modules['examples'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import pkgutil, importlib, repro_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "assert {'repro_torch.harness.runner', 'repro_torch.benchmarks.run',\n"
        "        'repro_torch.examples.train_100m'} <= set(names), names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.channel import InProcessChannel\n"
        "from repro_torch.train.loop import train\n"
        "s, st = train(configs.get('tinyllama-1.1b').reduced(), steps=2,\n"
        "              batch=2, seq=16, channel=InProcessChannel(),\n"
        "              device='cpu')\n"
        "assert st.checkpointer.shadow.consolidate()['step'] == 2\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, steps=1, batch=2, seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy({}, {}, {}, 0)
    state = make_train_state(cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in state.params.values())
    from repro_torch.core.buckets import layout_for_tree
    from repro_torch.core.elastic import rebuild_shadow
    from repro_torch.core.recovery import checkpoint_from_state
    from repro_torch.core.shadow import ShadowCluster
    from repro_torch.harness import GOLDEN, run_scenario
    for name in ("inprocess-clean", "full-inprocess-recovery"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_scenario(GOLDEN[name])
    old = ShadowCluster(layout_for_tree(state.params), OptimizerConfig(),
                        device="cpu")
    old.bootstrap(state.params, state.mu, state.nu, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rebuild_shadow(old, checkpoint_from_state(state))
    assert rebuild_shadow(old, checkpoint_from_state(state),
                          device="cpu").consolidate()["step"] == 0


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels import ops
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        ops.pack_bucket([meta], [0], torch.zeros(4, device="meta"))
    assert to_numpy(torch.ones(2, dtype=torch.bfloat16)).dtype == np.float32
