"""Cost planner: Appendix A/B analysis for your own cluster, the port of
``examples/cost_planner.py``.

Reproduces the paper's headline numbers (Fig 1) and then answers: at YOUR
scale/failure rate/overhead, how much does Checkmate save, and what does
the shadow plane cost (§4.4 resource plan)? Host arithmetic only: the
figures are the JAX example's. ``--device`` is taken as by every example;
nothing here runs on a device.

    python -m repro_torch.examples.cost_planner [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import costmodel as cm
from repro_torch.device import resolve
from repro_torch.examples._cli import parser
from repro_torch.net.planner import PlanInput, plan


def main(argv=None) -> dict:
    resolve(parser(__doc__).parse_args(argv).device)
    p = cm.CostParams()                        # LLaMA3-405B defaults
    it = cm.iteration_time(cm.LLAMA3_405B, 400e12, 16384)
    print("== Paper validation (LLaMA3-405B, 16K H100, Meta failure rate) ==")
    print(f"iteration time (App. A): {it:.2f} s  (paper: 4.58 s)")
    print(f"optimal checkpoint freq f*: every "
          f"{cm.optimal_frequency(p):.0f} iterations")
    print(f"wasted GPU-h at f* (SOTA):  {cm.wasted_gpu_hours_sota_min(p):,.0f}")
    print(f"wasted GPU-h (Checkmate):   {cm.wasted_gpu_hours_checkmate(p):,.0f}")
    print(f"30-min interval waste:      {cm.wasted_gpu_hours_sota(393, p):,.0f}"
          f"  (paper: ~1.7M)")
    print(f"CPU-node-hours for shadow:  {cm.cpu_node_hours(p):,.0f} "
          f"(paper: 166K)")
    print(f"net savings: ${cm.savings_usd(p):,.0f}")

    print("\n== Fig 11 sweep: saved GPU-h/day by scale (Meta failure rate) ==")
    sweep = cm.sweep_overhead(p, [0.01, 0.1, 0.5, 1.2, 5.0],
                              [4096, 8192, 16384])
    print("omega(s): " + "".join(f"{w:>10}" for w, _ in sweep[4096]))
    for n, rows in sweep.items():
        print(f"N={n:<6d}  " + "".join(f"{s:>10.0f}" for _, s in rows))

    print("\n== §4.4 network resource plan (16K accelerators, 128 DP groups) ==")
    pl = plan(PlanInput(n_accelerators=16384, dp_groups=128,
                        ranks_per_group=128),
              grad_bytes_total=405e9 * 2, iter_time_s=4.58)
    print(f"multicast streams: {pl.multicast_streams}  extra ports: "
          f"{pl.extra_ports}  ({pl.extra_port_fraction:.2%} of fabric)")
    print(f"hosts: {pl.hosts}  grad bytes/host: "
          f"{pl.grad_bytes_per_host / 1e6:.0f} MB  PCIe util: "
          f"{pl.pcie_util:.1%}  feasible: {pl.feasible}")
    return {"iteration_time_s": it,
            "optimal_frequency": cm.optimal_frequency(p),
            "wasted_sota_min": cm.wasted_gpu_hours_sota_min(p),
            "wasted_checkmate": cm.wasted_gpu_hours_checkmate(p),
            "cpu_node_hours": cm.cpu_node_hours(p),
            "savings_usd": cm.savings_usd(p), "sweep": sweep,
            "plan": pl}


if __name__ == "__main__":
    main()
