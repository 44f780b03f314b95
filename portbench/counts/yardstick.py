"""The card's peaks, against which every least time is counted.

Frozen copy of ``chip_smoke.py``'s constants and of its ``_int_ms``.  An SM of
Hopper runs 64 int32 operations a clock on its ALU lanes and dispatches 128
lanes a clock in all (NVIDIA H100 white paper): logic, shifts, compares,
selects and popcounts take the ALU alone, multiplies and adds may also take
the FMA pipe.  Float32 outside the tensor cores: 67 TFLOP/s; HBM: 3.35 TB/s
(NVIDIA H100 SXM data sheet).  The SM count comes from the card's properties
and the SM clock from ``nvidia-smi``'s ``clocks.max.sm``.
"""

from __future__ import annotations

import dataclasses
import subprocess

INT32_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Peaks:
    sms: int
    max_sm_mhz: float
    name: str = ""
    power_limit: str = "not measured"

    def int_s(self, alu: float, muladd: float) -> float:
        """Least seconds for ``alu`` ALU-only and ``muladd`` multiply/add operations."""
        clocks = max(alu / INT32_LANES_PER_SM, (alu + muladd) / DISPATCH_LANES_PER_SM)
        return clocks / (self.sms * self.max_sm_mhz * 1e6)

    @staticmethod
    def flop_s(flops: float) -> float:
        return flops / F32_FLOPS_PER_S

    @staticmethod
    def byte_s(nbytes: float) -> float:
        return nbytes / HBM_BYTES_PER_S


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading of the first card, or "not measured"."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not measured"


def card_peaks(index: int = 0) -> Peaks:
    """The peaks of CUDA card ``index``."""
    import torch

    props = torch.cuda.get_device_properties(index)
    clock = smi("clocks.max.sm")
    mhz = float(clock.split()[0]) if clock != "not measured" else float("nan")
    return Peaks(sms=props.multi_processor_count, max_sm_mhz=mhz,
                 name=torch.cuda.get_device_name(index), power_limit=smi("power.limit"))
