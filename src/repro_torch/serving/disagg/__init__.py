"""Disaggregated prefill/decode serving: engine roles, KV-block transfer,
and the migration-aware front door (ports ``repro/serving/disagg/``). The
design in short lives in ``coordinator``'s module docstring; the copy
between pools in ``transfer``'s."""
from repro_torch.serving.disagg.coordinator import (DisaggCoordinator,
                                                    STAGE_DECODE, STAGE_DONE,
                                                    STAGE_PREFILL,
                                                    STAGE_QUEUED,
                                                    STAGE_TRANSFER)
from repro_torch.serving.disagg.transfer import (HostRoundtripTransport,
                                                 InProcessTransport,
                                                 TransferBuffer,
                                                 TransferEntry, Transport)

__all__ = [
    "DisaggCoordinator",
    "TransferBuffer",
    "TransferEntry",
    "Transport",
    "InProcessTransport",
    "HostRoundtripTransport",
    "STAGE_QUEUED",
    "STAGE_PREFILL",
    "STAGE_TRANSFER",
    "STAGE_DECODE",
    "STAGE_DONE",
]
