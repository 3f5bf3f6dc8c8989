"""Which phase of the iteration each device operation belongs to, and what
the host was in while the device sat idle, over one traced window of a
cell on the card. The benchmark's runs do not run this.

    python3 bench/phases.py --workload gpt2-1.5b.checkmate --seed 7 \
        --seconds 10

Sets the cell up and runs its window as ``bench/harness.py`` does (the
same warm-up, ``torch.profiler`` over the device alone, a marker kernel at
the window's start and each iteration's end) under an enabled
``repro_torch.obs`` session, without the check against the reference.
The profiler's trace and the program's spans share one clock
(``bench/spans.py``), so each device operation is put in the span it was
launched in. Prints one JSON line (``bench/spans.py::phases``): the
mean ``data.batch`` span (``batch_ms``), per iteration the device ms of the forward, backward and optimizer
(``fwd_device_ms``, ``bwd_device_ms``, ``opt_device_ms``), the window's
idle shares while the trainer is in ``data.batch`` and in the step's
phases (``data_idle``, ``dispatch_idle``, %), the capture's copy rate
(``capture_copy_gbps``), the shadow's copies and update per apply
(``shadow_h2d_ms``, ``shadow_update_ms``), and the clock checks
(``owned_share``, ``marker_depth_us``, ``clock_shift_us``,
``markers_thread_spans``). Exits with 1 without a CUDA device.
"""
import argparse
import gc
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traced_window(cell, seed: int, seconds: float, path: str) -> dict:
    """One traced window of ``cell`` on the card, its device trace written
    to ``path``; returns the tracer's ``export()``, ``base_ns`` and
    ``threads``."""
    import torch

    from bench import harness
    from bench.reference.inputs import make_params, param_layout
    from repro_torch import obs
    from repro_torch.optim.functional import OptimizerConfig, init_state
    from repro_torch.train.loop import train

    device = torch.device("cuda")
    model, traffic = cell.config["model"], cell.traffic
    cfg = harness.model_config(cell.config, traffic)
    layout = param_layout(model)
    o = traffic["optimizer"]
    opt = OptimizerConfig(name=o["name"], lr=o["lr"], b1=o["b1"],
                          b2=o["b2"], eps=o["eps"],
                          weight_decay=o["weight_decay"])
    init = [init_state(make_params(layout, seed, device))]
    ck = harness.build_checkpointer(traffic, init[0], opt, device)
    shadow = getattr(ck, "shadow", None)
    hook = harness.Window(layout=layout, seed=seed, opt=opt,
                          warmup=traffic["warmup_steps"], seconds=seconds,
                          trace=True, shadow=shadow, device=device)
    with obs.enabled_session() as ob:
        try:
            train(cfg, steps=harness.FOREVER, batch=traffic["batch"],
                  seq=traffic["seq"], opt=opt, lr_fn=lambda s: o["lr"],
                  checkpointer=ck, seed=seed, state=init.pop(),
                  step_hook=hook, device=device)
        except harness._Stop:
            pass
        finally:
            gc.unfreeze()
        if shadow is not None:
            shadow.shutdown()
            ck.channel.close()
        out = {"export": ob.tracer.export(), "base_ns": ob.tracer.base_ns,
               "threads": {k: sorted(v)
                           for k, v in ob.tracer.threads.items()}}
    hook.prof.export_chrome_trace(path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 bench/phases.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    # the package from the root, and not this script's folder, whose
    # modules would shadow others of the same name (``trace``)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    from bench.run import caches
    caches(ROOT)
    import torch

    from bench import harness, spans, spec
    if not torch.cuda.is_available():
        print("phases: needs a CUDA device", file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        got = traced_window(cell, args.seed, args.seconds, path)
        trace = spans.load(path)
    threads = {k: set(v) for k, v in got["threads"].items()}
    out = spans.phases(trace, got["export"], got["base_ns"], threads)
    out.update(workload=args.workload, seed=args.seed,
               card=harness.card_label(torch.device("cuda")))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
