"""Three-term roofline, the port of ``repro.launch.roofline``, at the peaks
of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W):

  peak_bf16  = 989 TFLOP/s per card (tensor cores, dense)
  hbm_bw     = 3.35 TB/s per card (HBM3)
  nvlink_bw  = 25 GB/s per link and direction (NVLink 4: 900 GB/s over 18
               links, both directions). As the JAX module does with its
               interconnect, every collective byte is charged against one
               link of each card: a conservative serialization, not the
               card's aggregate NVLink bandwidth.

  compute term    = FLOPs per card / peak_bf16
  memory term     = bytes per card / hbm_bw
  collective term = collective bytes per card / nvlink_bw

A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
below these peaks under load; a share of them is stated with the card's
power limit beside it.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_BF16 = 989e12          # FLOP/s per card, bf16 tensor cores, dense
HBM_BW = 3.35e12            # B/s per card, HBM3
NVLINK_BW = 25e9            # B/s per NVLink 4 link, one direction
# the other units' data-sheet peaks, which the kernels' bounds use
PEAK_TF32 = 495e12          # FLOP/s, TF32 tensor cores, dense
PEAK_F32 = 67e12            # FLOP/s, f32 outside the tensor cores


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float            # analytic 6*N*D (train) / 2*N*D (serve)
    per_collective: dict

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total FLOPs — remat/redundancy waste detector."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_time_s * self.chips * PEAK_BF16
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops,
            "hlo_flops_total": self.flops_per_device * self.chips,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_at_roofline": self.mfu,
            "per_collective": self.per_collective,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train (N = active params for MoE),
    2*N*D forward-only for prefill/decode (D = tokens processed)."""
    n = cfg.active_param_count() if cfg.num_experts else cfg.param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch * 1          # decode: one token per sequence
    return 2.0 * n * d
