"""The per-layer FSDP schedule of the port's step over ranks, on the CPU.

An FSDP leaf's slice is cast to the compute dtype and gathered a layer at
a time inside the checkpointed layer (and again in its recompute), and
its gradient reduce-scattered onto the slice when the layer's backward
ends (`repro_torch.dist.sharding.gather_per_layer`). Four gloo ranks
(``tests/_torch_fsdp_workers.py::fsdp_schedule``) run:

- at microbatches 1, tinyllama on (4, 1), arctic on (2, 2) (its experts
  over model, their ``wemb`` dim over data) and one config of every
  other family on (4, 1), 3 steps, bf16 compute: the loss, the grad
  norm, the owned slices and the state are bitwise those of the
  whole-tree schedule (every FSDP leaf gathered whole in f32 before the
  forward, every gradient reduce-scattered after the backward), which the
  worker file writes out from the port's pieces;
- at microbatches 2, tinyllama and arctic captured through a
  `RankCapture` into a 2-node shadow: the trainer's state is the
  shadow's, bit for bit, and every element of every leaf is captured
  exactly once a step.

On a fake (4, 1) world (a subprocess: no xdist worker keeps a process
group) `analyze_step` traces a 16-layer tinyllama at 8 positions: the
step's temporaries stay below ``TEMP_FRACTION`` of the bytes of the whole
gathered stack in the compute dtype plus its f32 gradient, and the
whole-tree schedule's exceed that.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from _torch_fsdp_workers import CAPTURED, CASES, STEPS
from _torch_spawn import spawn

torch.set_num_threads(2)   # leave cores to the other test workers

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
# the per-layer step's temporaries against the stacked FSDP leaves' bytes
# gathered in the compute dtype (2 B an element) plus their f32 gradient
# (4 B): the whole-tree schedule holds the f32 gather, its bf16 cast and
# the f32 gradient of every layer at once (10 B an element, 1.8 times the
# bound's 6 B at the traced cut), the per-layer one a layer's worth of
# those and the f32 gradient of its own slices (0.2 times it there)
TEMP_FRACTION = 0.5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    spawn("_torch_fsdp_workers", "fsdp_schedule", WORLD, d, str(d),
          timeout=240)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


@pytest.mark.parametrize("tag", list(CASES))
def test_per_layer_schedule_is_the_whole_tree_one_bitwise(ranks, tag):
    """At microbatches 1 every number of every rank is the whole-tree
    schedule's, bit for bit: the cast commutes with the gather, and each
    layer's reduce-scatter puts every element in the chunk, and the ring
    order, of the whole leaf's."""
    assert ranks[0][f"{tag}/fsdp_leaves"]      # the case cuts leaves
    for r, out in enumerate(ranks):
        for t in range(STEPS):
            for key in ("loss", "gnorm"):
                _equal(out[f"{tag}/layer/{key}/{t}"],
                       out[f"{tag}/tree/{key}/{t}"], (r, key, t))
            got, want = out[f"{tag}/layer/owned/{t}"], \
                out[f"{tag}/tree/owned/{t}"]
            assert set(got) == set(want)
            for k in want:
                _equal(got[k], want[k], (r, "owned", t, k))
        got, want = out[f"{tag}/layer/state"], out[f"{tag}/tree/state"]
        assert got["step"] == want["step"] == STEPS
        for tree in ("params", "mu", "nu"):
            for k in want[tree]:
                _equal(got[tree][k], want[tree][k], (r, tree, k))


@pytest.mark.parametrize("tag", CAPTURED)
def test_per_layer_trainer_state_is_the_shadows_bitwise(ranks, tag):
    trainer = ranks[0][f"{tag}/capture/trainer"]
    shadow = ranks[0][f"{tag}/capture/shadow"]
    assert ranks[0][f"{tag}/capture/n_checkpoints"] == STEPS
    assert shadow["step"] == trainer["step"] == STEPS
    for tree in ("params", "mu", "nu"):
        assert set(shadow[tree]) == set(trainer[tree])
        for k, t in trainer[tree].items():
            _equal(shadow[tree][k], t, (tree, k))


@pytest.mark.parametrize("tag", CAPTURED)
def test_per_layer_capture_covers_every_element_once(ranks, tag):
    """Over the ranks' marks of a step, every element of every leaf is
    captured exactly once."""
    shapes = {k: tuple(v.shape) for k, v in
              ranks[0][f"{tag}/capture/trainer"]["params"].items()}
    for t in range(STEPS):
        seen = {k: torch.zeros(s, dtype=torch.int32)
                for k, s in shapes.items()}
        for out in ranks:
            for k, cuts in out[f"{tag}/capture/marks/{t}"]:
                view = seen[k]
                for d, lo, hi in cuts:
                    view = view.narrow(d, lo, hi - lo)
                view += 1
        for k, c in seen.items():
            assert torch.all(c == 1), (t, k)
    assert sum(ranks[0][f"{tag}/capture/received/{t}"]
               for t in range(STEPS)) > 0


TRACE = """
import json, sys
sys.path.insert(0, sys.argv[2])
from _torch_fsdp_workers import whole_tree_step
from repro_torch import configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import Mesh, ShardingRules
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import registry
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.step import abstract_train_state, build_train_step

cfg = C.get("tinyllama-1.1b").reduced(num_layers=16)
out = {"leaves": [[list(s.shape), s.logical[:1] == ("layers",),
                   "wemb" in s.logical]
                  for s in registry.param_specs(cfg).values()]}
with fake_world(4):
    mesh = Mesh.over_ranks((4, 1), ("data", "model"), device="cpu")
    rules = ShardingRules(mesh, fsdp=True)
    opt = OptimizerConfig(grad_clip=0.0)
    for tag, build in (("layer", build_train_step),
                       ("tree", whole_tree_step)):
        r = analyze_step(build(cfg, opt, lambda s: 1e-3, rules),
                         abstract_train_state(cfg, rules),
                         registry.input_specs(cfg, ShapeConfig(
                             "t", 8, 4, "train"), rules))
        out[tag] = r["memory"]
        out[tag + "/collectives"] = r["per_collective"]
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(TRACE),
                          path, HERE], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def test_per_layer_temporaries_stay_below_the_gathered_stack(traced):
    """The stacked FSDP leaves gathered in bf16 plus their f32 gradient
    bound the temporaries from above by ``TEMP_FRACTION``; the
    whole-tree schedule's pass that bound."""
    def numel(stacked):
        return sum(math.prod(shape) for shape, st, fsdp
                   in traced["leaves"] if fsdp and st == stacked)
    stack, other = numel(True), numel(False)
    bound = TEMP_FRACTION * stack * (2 + 4)
    assert traced["layer"]["temp_bytes"] < bound, (traced["layer"], bound)
    assert traced["tree"]["temp_bytes"] > bound, (traced["tree"], bound)
    # this rank's quarter of each leaf on the wire: whole-tree, every leaf
    # once in f32; per layer, in bf16, a stacked leaf's slices twice (the
    # forward and the remat recompute), the others once
    layer, tree = traced["layer/collectives"], traced["tree/collectives"]
    assert tree["allgather_"] == 4 * (stack + other) // WORLD
    assert layer["allgather_"] == 2 * (2 * stack + other) // WORLD
    # the per-layer reduce-scatters send what the whole leaves' did
    assert layer["send"] == tree["send"]
