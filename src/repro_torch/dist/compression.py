"""int8 gradient compression with error feedback (EF-SGD style), the port of
``repro.dist.compression``.

Per-leaf scheme, bitwise the JAX package's on the CPU:

* add the carried error-feedback residual to the raw gradient,
* symmetric linear quantization to int8 with a per-leaf f32 scale
  (``scale = max|g + ef| / 127``, at least ``finfo(float32).tiny``), so the
  per-element error is at most scale/2; rounding is half to even
  (``torch.round``, as ``jnp.round``),
* the new residual is exactly the quantization error, so repeated
  quantization of a constant gradient averages to the true value.

Subnormal values count as zero: the sum ``g + ef`` and the residual are
flushed to (signed) zero below ``finfo(float32).tiny``, as the JAX
package's codec computes on its CPU and TPU backends (both flush
subnormals). PyTorch keeps subnormals on the CPU and the card, so the
codec flushes them itself and gives the same bits on either.

Wire format per leaf: the int8 payload + one f32 scale. Every function
runs on the device its inputs live on, so the codec runs on the card when
handed the capture's device buckets; its residuals stay there.
"""
from __future__ import annotations

import torch

from repro_torch.core.buckets import Bucket, BucketLayout, FlatTreeView

_QMAX = 127.0
_TINY = torch.finfo(torch.float32).tiny


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal elements to zero of the same sign."""
    return torch.where(torch.abs(x) < _TINY, x * 0.0, x)


def _quantize(g: torch.Tensor, ef) -> tuple:
    """``(q, scale, target)`` of `quantize_leaf`: ``target`` is the
    flushed ``g + ef`` that ``q * scale`` approximates."""
    ef = torch.as_tensor(ef, dtype=torch.float32, device=g.device)
    target = _flush(_flush(g.to(torch.float32)) + _flush(ef))
    scale = torch.max(torch.abs(target)) / _QMAX
    safe = torch.clamp_min(scale, _TINY)
    q = (target / safe).round_().clamp_(-_QMAX, _QMAX).to(torch.int8)
    return q, safe, target


def quantize_leaf(g: torch.Tensor, ef) -> tuple:
    """Quantize one gradient leaf with error feedback.

    Returns ``(q, scale, new_ef)``: int8 payload, 0-d f32 scale, and the
    residual to carry into the next iteration
    (``dequantize_leaf(q, scale) + new_ef == g + ef`` exactly in f32).
    """
    q, safe, target = _quantize(g, ef)
    deq = q.to(torch.float32) * safe
    return q, safe, _flush(target - deq)


def dequantize_leaf(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_flat_stateless(bucket: Bucket, flat: torch.Tensor) -> tuple:
    """Stateless (no-error-feedback) int8 quantization of one wire-layout
    flat buffer: per-slot, the same rounding as `quantize_leaf` with a zero
    residual, and no residual produced. Returns ``(q, scales)``: int8
    payload the length of the bucket and one f32 scale per slot."""
    src = flat.to(torch.float32)
    q = torch.empty(bucket.size, dtype=torch.int8, device=flat.device)
    scales = torch.empty(len(bucket.slots), dtype=torch.float32,
                         device=flat.device)
    for i, s in enumerate(bucket.slots):
        sl = slice(s.offset, s.offset + s.size)
        q[sl], scales[i], _ = _quantize(src[sl], 0.0)
    return q, scales


def dequantize_flat_stateless(bucket: Bucket, q: torch.Tensor,
                              scales: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_flat_stateless`: f32 flat buffer."""
    out = torch.empty(bucket.size, dtype=torch.float32, device=q.device)
    for i, s in enumerate(bucket.slots):
        sl = slice(s.offset, s.offset + s.size)
        torch.mul(q[sl].to(torch.float32), scales[i], out=out[sl])
    return out


def init_error_feedback(tree: dict) -> dict:
    """Zero residuals matching the gradient tree (leaf name -> tensor)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in tree.items()}


def compress_tree(tree: dict, ef: dict) -> tuple[dict, dict, int]:
    """Quantize a gradient leaf tree; returns ``(deq, new_ef, wire_bytes)``.

    ``deq`` is what the trainer applies and the shadow receives, so both
    run the optimizer on the same dequantized gradients; ``wire_bytes`` is
    the int8 payload plus one f32 scale per leaf.
    """
    deq, residuals, wire = {}, {}, 0
    for k, g in tree.items():
        q, scale, r = quantize_leaf(g, ef[k])
        deq[k] = dequantize_leaf(q, scale)
        residuals[k] = r
        wire += q.numel() + 4
    return deq, residuals, wire


def compression_ratio(tree: dict) -> float:
    """Uncompressed bytes / wire bytes for a gradient tree (~4x for f32)."""
    raw = sum(t.numel() * t.element_size() for t in tree.values())
    wire = sum(t.numel() + 4 for t in tree.values())
    return raw / wire


class Compressor:
    """Stateful int8+EF compressor for a gradient stream in wire layout.

    Owns the error-feedback residuals across calls, one flat f32 buffer per
    bucket on the device of the first flats it is given.
    """

    def __init__(self):
        self._ef_flat: dict | None = None   # bucket_id -> flat f32 residual
        self._layout: BucketLayout | None = None
        self.wire_bytes_total = 0
        self.raw_bytes_total = 0

    def compress_flats(self, layout: BucketLayout, flats: dict) -> dict:
        """Quantize one iteration in wire layout (bucket_id -> flat buffer);
        returns fresh dequantized f32 flats on the same device.

        Each leaf's contiguous slice is quantized with its own scale (the
        per-leaf max, which the slice preserves), so the values and
        residuals are those of quantizing the leaf tree.
        """
        if self._ef_flat is None:
            self._layout = layout
            self._ef_flat = {
                b.bucket_id: torch.zeros(b.size, dtype=torch.float32,
                                         device=flats[b.bucket_id].device)
                for b in layout.buckets}
        deq, wire, raw = {}, 0, 0
        for b in layout.buckets:
            src = flats[b.bucket_id]
            out = torch.empty(b.size, dtype=torch.float32, device=src.device)
            ef = self._ef_flat[b.bucket_id]
            for s in b.slots:
                sl = slice(s.offset, s.offset + s.size)
                q, scale, r = quantize_leaf(src[sl], ef[sl])
                out[sl] = dequantize_leaf(q, scale)
                ef[sl] = r
                wire += s.size + 4
            raw += src.numel() * src.element_size()
            deq[b.bucket_id] = out
        self.wire_bytes_total += wire
        self.raw_bytes_total += raw
        return deq

    @property
    def ef(self):
        """The error-feedback residuals as a leaf view (None before the
        first call): exactly the gradient mass not yet delivered."""
        if self._ef_flat is None:
            return None
        return FlatTreeView(self._layout, self._ef_flat)

    @property
    def ratio(self) -> float:
        return (self.raw_bytes_total / self.wire_bytes_total
                if self.wire_bytes_total else 0.0)
