"""The reference's two multi-rank elastic drills (tests/test_elastic.py) on
the port, one gloo rank per device on the CPU, on the reference's meshes
and with its checks and bounds (the workers are in
``tests/_torch_dp_workers.py``):

* ``test_elastic_restore_across_meshes``: 8 ranks as (4 data, 2 model),
  3 captured steps into a 2-node shadow on rank 0; ranks 4..7 lost; the
  survivors replan (2, 2), ``recover(new_rules=)`` at step 3 lands the
  params to rtol 1e-6 / atol 1e-7 of the pre-failure trainer's, and one
  more step's loss is within 5e-3 of continuing on (4, 2);
* ``test_fsdp_to_pure_dp_restore``: FSDP on 4 ranks, 2 steps, then pure
  DP on 2, the params to the same bound, and the next step runs.
"""
from _torch_spawn import spawn


def test_elastic_restore_across_meshes(tmp_path):
    spawn("_torch_dp_workers", "elastic_across_meshes", 8, tmp_path)


def test_fsdp_to_pure_dp_restore(tmp_path):
    spawn("_torch_dp_workers", "fsdp_to_dp", 4, tmp_path)
