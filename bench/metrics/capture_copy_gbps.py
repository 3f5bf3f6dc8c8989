"""Capture (``train/loop.py::Capture``, ``core/channel.py::to_host``): the
rate of the capture's copy off the card, GB/s: the ``bytes`` of the
window's ``capture.to_host`` spans over the device time of its copies,
the window's longest copies from the card into pinned host memory on the
stream the harness's markers ran on, one a bucket and iteration. The
trainer's other such copies are its reads of a scalar (the loss, 4
bytes, which PyTorch reads through pinned memory); the shadow copies
only onto the card. Fewer such copies than buckets and iterations reads
nothing."""
import sys

UNIT, LAYER, MOVES = "GB/s", "capture", "ckpt_stall_ms"


def read(run):
    p = run.profile
    if p is None:
        return None
    nbytes = sum(e["args"]["bytes"] for e in run.spans
                 if e["name"] == "capture.to_host")
    times = sorted((b - a for name, a, b, st in p.copies
                    if st == p.main_stream and "DtoH" in name
                    and "Pinned" in name and b > p.start and a < p.end),
                   reverse=True)
    if not nbytes or not times:
        return None
    want = run.n_iters * run.n_buckets
    if len(times) < want:
        print(f"capture_copy_gbps: {len(times)} copies, {want} expected",
              file=sys.stderr)
        return None
    return nbytes / sum(times[:want]) / 1e9
