"""Deterministic chaos co-simulation harness, the port of ``repro.harness``.

Declarative `Scenario` specs drive the port's stack — train loop ->
GradientChannel -> fabric simulator -> shadow plane -> durability ->
recovery — under a seeded `FailureSchedule`, with a registry of
system-wide `Invariant` checkers evaluated after every step. Violations
emit minimal repro bundles (seed + scenario JSON + failing step) that
replay bit-identically, on this package or the reference.

    from repro_torch.harness import GOLDEN, run_scenario
    result = run_scenario(GOLDEN["gated-then-recovery"], device="cpu")
    assert result.passed, result.violations

CLI: ``python -m repro_torch.harness {run,sweep,replay}``.
"""
from repro_torch.harness.corpus import GOLDEN                    # noqa: F401
from repro_torch.harness.invariants import (REGISTRY,            # noqa: F401
                                            Invariant, Violation,
                                            register)
from repro_torch.harness.runner import (InstrumentedChannel,     # noqa: F401
                                        ScenarioResult, StepRecord, Trace,
                                        replay_bundle, run_scenario,
                                        write_bundle)
from repro_torch.harness.scenario import (ChannelSpec,           # noqa: F401
                                          DurabilitySpec, FabricFailure,
                                          FailureSchedule, Scenario,
                                          ShadowDeath, ShadowPlaneLoss,
                                          TierFailure, TrainNodeLoss,
                                          repro_seed, sample_scenario,
                                          scenario_strategy)
