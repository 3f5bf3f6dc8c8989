"""`repro_torch.net` — the network plane, the port's copy of ``repro.net``.

Packet/frame model (`packets`), switch match-action data plane (`switch`),
priority flow control (`pfc`), fabric topology construction + §4.4 resource
planning (`planner`), and the event-driven multi-switch simulator
(`simulator`). All of it is host code over Python ints and floats; see
docs/netsim.md for the simulator's model and usage.
"""
from repro_torch.net.packets import MTU, Frame, frames_for_chunk  # noqa: F401
from repro_torch.net.pfc import PfcConfig, PfcQueue  # noqa: F401
from repro_torch.net.planner import (  # noqa: F401
    LinkSpec, Plan, PlanInput, Topology, build_topology, plan,
)
from repro_torch.net.switch import SwitchCounters, SwitchDataPlane  # noqa: F401

_SIMULATOR_API = (
    "FabricResult", "FabricSimulator", "FailureSpec", "SimResult",
    "simulate_allgather_replication", "simulate_fabric",
    "sweep_replication", "sweep_topology",
)


def __getattr__(name):
    # lazy so `python -m repro_torch.net.simulator` does not double-import
    # the module it is about to execute (runpy RuntimeWarning)
    if name in _SIMULATOR_API:
        from repro_torch.net import simulator
        return getattr(simulator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
