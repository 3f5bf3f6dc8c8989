"""repro_torch.durability — tiered differential persistence behind the
shadow, the port of ``repro.durability``.

The shadow turns every iteration into a checkpoint, but it lives in the
shadow nodes' memory: lose the whole plane and the checkpoint is gone.
Per-node background `FlushWorker`s snapshot dirty bucket flats into
checksummed base/delta `FlushRecord`s (the JAX package's bytes), write
them through pluggable `Tier`s (local disk with atomic rename + manifest,
an object-store stub), and `restore_from_tiers` rebuilds a full
consolidated checkpoint from the base + delta chain — all without adding
a stall stage to the trainer's ledger.
"""
from repro_torch.durability.flush import (DurableShadow, FlushPolicy,
                                          FlushWorker)
from repro_torch.durability.record import FlushRecord, TornRecordError
from repro_torch.durability.restore import (TierRestoreError,
                                            restore_from_tiers,
                                            restore_shards_from_tiers)
from repro_torch.durability.tiers import (LocalDiskTier, ManifestEntry,
                                          ObjectStoreTier, Tier, TierPutError)

__all__ = [
    "DurableShadow", "FlushPolicy", "FlushWorker",
    "FlushRecord", "TornRecordError",
    "TierRestoreError", "restore_from_tiers", "restore_shards_from_tiers",
    "LocalDiskTier", "ManifestEntry", "ObjectStoreTier", "Tier",
    "TierPutError",
]
