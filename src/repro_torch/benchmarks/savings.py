"""Fig 1 + Fig 11 + §6.7: cost-model curves (wasted GPU-hours vs frequency,
savings vs scale/failure-rate/overhead), the port of
``benchmarks/savings.py``. Host arithmetic only: the rows are the JAX
module's, string for string."""
from __future__ import annotations

import time

from repro_torch.benchmarks.common import csv_row
from repro_torch.core import costmodel as cm


def run() -> list[tuple]:
    p = cm.CostParams()
    t0 = time.perf_counter()
    rows = []

    # -- Fig 1: wasted GPU-hours vs checkpoint frequency ----------------------
    freqs = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]
    curve = cm.sweep_frequencies(p, freqs)
    best_f, best_w = min(curve, key=lambda kv: kv[1])
    ck = cm.wasted_gpu_hours_checkmate(p)
    rows.append(csv_row("fig1.best_frequency", 0.0, f"f*={best_f}"))
    rows.append(csv_row("fig1.sota_min_gpu_hours", 0.0, f"{best_w:.0f}"))
    rows.append(csv_row("fig1.checkmate_gpu_hours", 0.0,
                        f"{ck:.0f} (paper: 4367; cut={1 - ck / best_w:.1%})"))
    f30 = 30 * 60 / p.iter_time_s
    rows.append(csv_row("fig1.30min_interval_gpu_hours", 0.0,
                        f"{cm.wasted_gpu_hours_sota(f30, p):.0f} "
                        f"(paper: ~1.7M)"))

    # -- Fig 11: savings sweeps ------------------------------------------------
    for rate, tag in [(2.0e-5, "meta_rate"), (1.0e-6, "low_rate")]:
        q = cm.CostParams(failure_rate=rate)
        sw = cm.sweep_overhead(q, [0.01, 1.2], [4096, 16384])
        for n, pts in sw.items():
            for w, saved in pts:
                rows.append(csv_row(f"fig11.{tag}.N{n}.omega{w}", 0.0,
                                    f"saved_gpu_h_per_day={saved:.0f}"))
    lo = cm.gpu_hours_saved_per_day(cm.CostParams(failure_rate=1e-6)) * 54
    rows.append(csv_row("fig11.54day_low_rate_total", 0.0,
                        f"{lo:.0f} (paper: ~70000)"))

    # -- validation anchors (Appendix A) --------------------------------------
    rows.append(csv_row(
        "appA.iter_time_s", 0.0,
        f"{cm.iteration_time(cm.LLAMA3_405B, 400e12, 16384):.2f} "
        f"(paper 4.58)"))
    rows.append(csv_row("appA.ckpt_time_s", 0.0,
                        f"{cm.checkpoint_time(405e9):.2f} (paper 1.2)"))
    rows.append(csv_row("appB.cpu_node_hours", 0.0,
                        f"{cm.cpu_node_hours(p):.0f} (paper 166K)"))
    rows.append(csv_row("savings.total_usd", (time.perf_counter() - t0) * 1e6,
                        f"{cm.savings_usd(p):.0f} (paper ~2.6M)"))
    return rows


if __name__ == "__main__":
    run()
