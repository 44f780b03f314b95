"""Route planning for self-driving with the hardware Bayesian inference
operator (paper Fig 3): a vehicle decides whether to cut into the target lane.

The two-node prior/likelihood motif is a declarative spec, frames stream
through ``FrameDriver`` (the compiled fused sweep underneath), and the
analytic reference comes from the enumeration oracle.

Run:  PYTHONPATH=src python -m repro_torch.examples.route_planning
"""

from __future__ import annotations

import numpy as np

from repro_torch.bayesnet import FrameDriver, NetworkSpec, Node, compile_network, make_posterior_fn
from repro_torch.bayesnet.compile import lower_streams
from repro_torch.core import correlation, latency, prng

# Scenario (Fig 3a): prior belief that cutting in is safe, evidence about the
# incoming (blue) vehicle on the target lane.
P_A = 0.57           # prior belief to cut in (traffic rules, road structure...)
P_B_GIVEN_A = 0.72   # chance of seeing this lane state if cutting in is safe
P_B_GIVEN_NOT_A = 0.60

SPEC = NetworkSpec(
    name="route-planning",
    nodes=(
        Node("cut_in", (), (P_A,)),
        Node("lane_state", ("cut_in",), (P_B_GIVEN_NOT_A, P_B_GIVEN_A)),
    ),
    evidence=("lane_state",),
    queries=("cut_in",),
)


def run(device="cuda", n_bits: int = 96, n_frames: int = 5, audit_bits: int = 1 << 14) -> dict:
    """Frames of B = 1 evidence through a ``FrameDriver`` at ``n_bits`` (the
    paper's ~100-bit frames, word-aligned), and the correlation audit of the
    lowered node streams at ``audit_bits``."""
    net = compile_network(SPEC, n_bits=n_bits, device=device)
    theory = make_posterior_fn(SPEC, device=device)(np.asarray([[1]]))[0][0, 0]
    driver = FrameDriver(net, max_batch=8, base_key=prng.PRNGKey(2024), salt=0)
    driver.submit(np.ones((n_frames, 1), np.int32))
    frames = sorted(driver.drain().items())
    # correlation audit (Fig 3c/3d): lane_state is driven by cut_in through the
    # gathered CPT, so the pair correlates; everything else stays clean
    streams = lower_streams(SPEC, prng.PRNGKey(2024), audit_bits, device=device)
    names = list(SPEC.topo_order())
    rho = correlation.correlation_matrix({n: streams[n][0] for n in names}, audit_bits, "pearson")
    return {"frames": frames, "theory": theory, "names": names, "rho": rho,
            "streams": streams, "latency": latency.memristor_latency(n_bits=100, n_sne=5)}


def main(device="cuda") -> None:
    r = run(device)
    theory = float(r["theory"])
    print("=== timely reliable route planning (memristor Bayes operator) ===")
    for trial, (post_vec, _) in r["frames"]:
        post = float(post_vec[0])
        decision = "CUT IN (belief increased)" if post > P_A else "KEEP LANE"
        print(f"frame {trial}: P(A|B) = {post:.2f}  (theory {theory:.2f})  -> {decision}")
    rep = r["latency"]
    print(f"\noperator latency @100 bits: {rep.frame_latency_s*1e3:.2f} ms/frame "
          f"({rep.fps:.0f} fps) -- paper claims <0.4 ms / 2,500 fps: "
          f"{'OK' if rep.meets_paper_claim() else 'MISS'}")
    print(f"reference: human driver brake reaction {latency.HUMAN_REACTION_S}, "
          f"ADAS {latency.ADAS_FPS} fps")
    print("\nPearson correlation matrix (stream order: " + ", ".join(r["names"]) + ")")
    print(np.array2string(r["rho"].cpu().numpy(), precision=2, suppress_small=True))


if __name__ == "__main__":
    main()
