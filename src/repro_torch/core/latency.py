"""Decision latency / energy model (the paper's timeliness claim).

The paper: with 100-bit stochastic numbers and < 4 us of switching per bit,
the Bayesian inference and fusion operators decide in < 0.4 ms per frame
(>= 2,500 fps), faster than human reaction and ADAS pipelines.  Comparator and
gate delays are neglected (memristor switching is the bottleneck).

:func:`memristor_latency` reproduces those numbers from the device constants.
:func:`throughput_model` is the packed mapping's order-of-magnitude decision
rate on a processor whose integer-operation rate the caller supplies: each
decision costs ``ceil(n_bits / 32)`` words times its gate operations plus
about 5 operations of popcount per word.  It has no default rate; a caller
passes the rate of the card it runs on.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.device import DEFAULT_PARAMS, MemristorParams

# Reference points quoted by the paper.
HUMAN_REACTION_S = (0.7, 1.5)   # paper cites 0.7-1.5 (ref 28, driver brake times;
                                # the paper text says "ms", the cited literature
                                # measures seconds -- the comparison holds either
                                # way since the operator is faster than both)
ADAS_FPS = (30.0, 45.0)         # advanced driver-assistance systems (ref 29)
CAMERA_FPS = (10.0, 30.0)       # sensor sampling (ref 32)
EDGE_NET_FPS = 300.0            # pre-trained edge detector (ref 33)


@dataclasses.dataclass(frozen=True)
class LatencyReport:
    n_bits: int
    frame_latency_s: float
    fps: float
    energy_per_decision_j: float
    n_sne: int

    def meets_paper_claim(self) -> bool:
        """Paper claim: < 0.4 ms per frame, i.e. >= 2,500 fps at 100 bits."""
        return self.frame_latency_s < 0.4e-3 and self.fps >= 2500.0


def memristor_latency(
    n_bits: int = 100,
    n_sne: int = 5,
    mean_p: float = 0.5,
    params: MemristorParams = DEFAULT_PARAMS,
) -> LatencyReport:
    """Latency/energy of one operator decision on the memristor substrate.

    The SNEs stream bits in parallel (one memristor each); the serial
    dimension is the bit index, so frame latency = n_bits * t_bit.  Energy
    counts one switching event per emitted 1-bit per SNE (expected fraction
    ``mean_p``).
    """
    latency = n_bits * params.t_bit
    energy = n_sne * n_bits * mean_p * params.e_switch
    return LatencyReport(
        n_bits=n_bits,
        frame_latency_s=latency,
        fps=1.0 / latency,
        energy_per_decision_j=energy,
        n_sne=n_sne,
    )


def throughput_model(int_ops_per_s: float, n_bits: int = 100, n_gate_ops: int = 8) -> float:
    """Decisions per second of the packed mapping (order-of-magnitude model).

    Each decision needs ``ceil(n_bits / 32)`` words x ``n_gate_ops`` bitwise
    operations, and popcount adds about 5 per word; ``int_ops_per_s`` is the
    processor's 32-bit integer-operation rate (one operation moves 32 stream
    bits).  Memory traffic is taken as negligible.
    """
    words = -(-n_bits // 32)
    return float(int_ops_per_s) / (words * (n_gate_ops + 5))
