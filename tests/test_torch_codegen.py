"""The per-plan ``net_sweep`` body, compiled as host C++, against the JAX reference.

``codegen.emit`` writes a gate program as straight-line C++ that compiles
for the card (inside ``csrc/net_sweep_kernel.cuh``) and for the host.  Here
``g++`` builds it into a small shared library with a host loop over every
(frame, word) item of a launch -- the kernel's item mapping and per-frame
sums -- and its counts and decisions are held bit for bit against
``repro.kernels.net_sweep.net_sweep_ref``.  Tests that need ``g++`` skip,
inside the test, where there is none.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

import repro.bayesnet as R
from repro.bayesnet import compile as rcompile
from repro.kernels.net_sweep import net_sweep_ref as jax_net_sweep_ref
import repro_torch.bayesnet as T
from repro_torch.bayesnet import compile as tcompile
from repro_torch.kernels.net_sweep import codegen, kernel, record_program
from torch_wide_net import wide_spec

NAMES = sorted(R.SCENARIOS)
KD = np.array([0x9E3779B9, 0x12345678], np.uint32)

# the kernel's item loop and per-frame sums, on the host
HARNESS = r"""
extern "C" void run(const int* ev, int n_ev, int* out, int n_cols, int n_batch,
                    int w_words, uint32_t kd0, uint32_t kd1, uint32_t frame0,
                    uint32_t n_frames) {
  const uint32_t node_stride = n_frames * (uint32_t)w_words;
  for (int f = 0; f < n_batch; ++f) {
    uint32_t c[ns_gen::kNOut] = {0};
    for (int w = 0; w < w_words; ++w) {
      const uint32_t pos = (frame0 + (uint32_t)f) * (uint32_t)w_words + (uint32_t)w;
      ns_gen::body(pos, (uint32_t)w, (uint32_t)w_words, node_stride, kd0, kd1,
                   ev + (std::size_t)f * n_ev, c);
    }
    int* o = out + (std::size_t)f * n_cols;
    for (int j = 0; j < ns_gen::kNOut; ++j) o[j] = (int)c[j];
    ns_gen::decide(o, o + ns_gen::kNOut);
  }
}
"""


def _specs(name):
    if name.startswith("wide-"):
        m = int(name.split("-")[1])
        return wide_spec(R, m), wide_spec(T, m)
    return R.by_name(name), T.by_name(name)


def _plans(name, noisy, epochs):
    rs, ts = _specs(name)
    noise = R.NoiseModel.nominal() if noisy else None
    tnoise = None if noise is None else T.NoiseModel(**dataclasses.asdict(noise))
    rp = rcompile.sweep_plan(rs, rs.queries, rs.evidence, noise=noise, drift_epochs=epochs)
    tp = tcompile.sweep_plan(ts, ts.queries, ts.evidence, noise=tnoise, drift_epochs=epochs)
    return rs, rp, tp


_LIBS = {}


def _host_library(tmp_path_factory, plan):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the generated body as host C++")
    src = ('#include "net_sweep_common.h"\n'
           + codegen.emit(record_program(plan), plan) + HARNESS)
    if src not in _LIBS:
        d = tmp_path_factory.mktemp("body")
        (d / "body.cpp").write_text(src)
        subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                        str(kernel.CSRC), "-o", str(d / "body.so"), str(d / "body.cpp")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(d / "body.so"))
        lib.run.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                            + [ctypes.c_int] * 3 + [ctypes.c_uint] * 4)
        _LIBS[src] = lib
    return _LIBS[src]


# (name, n_bits, batch, nominal noise, drift epochs, frame0, total_frames)
_CASES = (
    [(n, 1024, 16, False, 1, 0, None) for n in NAMES]
    + [("intersection", 1024, 16, True, 2, 0, None),
       ("intersection-cat", 1024, 16, True, 3, 0, None),
       ("lane-change", 2048, 8, True, 3, 0, None),
       # node offsets n * total * w_words and frame counters wrap 2**32
       ("intersection", 1024, 16, False, 1, 2**25 - 7, 2**25 + 9),
       ("obstacle-class", 1024, 8, True, 2, 2**27 + 5, 2**28),
       ("wide-7", 1024, 16, False, 1, 0, None),
       ("wide-7", 512, 16, True, 2, 2**26 - 3, 2**26 + 13),
       # epoch bounds that round half to even: 5 words in 2 epochs, 6 in 4
       ("intersection", 160, 8, True, 2, 0, None),
       ("lane-change", 192, 8, True, 4, 0, None)]
)
_IDS = [f"{c[0]}-{c[1]}b-B{c[2]}-{'noise' if c[3] else 'clean'}-E{c[4]}-f{c[5]}"
        for c in _CASES]


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_generated_body_on_the_host_equals_reference(case, tmp_path_factory):
    name, n_bits, b, noisy, epochs, frame0, total = case
    rs, rp, tp = _plans(name, noisy, epochs)
    w = n_bits // 32
    lib = _host_library(tmp_path_factory, tp)
    r = np.random.default_rng(n_bits + b + epochs)
    ev = np.stack([r.integers(0, rs.card(e), b) for e in rs.evidence], 1).astype(np.int32)
    numer, denom, dec = (np.asarray(x) for x in jax_net_sweep_ref(
        jnp.asarray(KD), jnp.asarray(ev), rp, n_bits, frame0=frame0, total_frames=total,
        decide=True))
    n_s, n_q = tp.n_value_slots, len(tp.queries)
    out = np.zeros((b, n_s + 1 + n_q), np.int32)
    lib.run(ev.ctypes.data, ev.shape[1], out.ctypes.data, out.shape[1], b, w, int(KD[0]),
            int(KD[1]), frame0 & 0xFFFFFFFF, (b if total is None else total) & 0xFFFFFFFF)
    np.testing.assert_array_equal(out[:, :n_s], numer)
    np.testing.assert_array_equal(out[:, n_s], denom)
    np.testing.assert_array_equal(out[:, n_s + 1:], dec)


def test_program_sources_are_keyed_by_their_text():
    """Plans whose programs are identical share one source (and library);
    no literal depends on the word count, drift epochs included."""
    _, _, clean = _plans("intersection", False, 1)
    _, _, drift = _plans("intersection", True, 3)
    _, _, drift2 = _plans("intersection", True, 3)
    assert kernel.program_source(drift) == kernel.program_source(drift2)
    assert kernel.program_source(clean) != kernel.program_source(drift)
    src = kernel.program_source(drift)
    assert src.index('#include "net_sweep_common.h"') < src.index("NS_HD void body") \
        < src.index('#include "net_sweep_kernel.cuh"')
    prog = record_program(drift)
    body = src[src.index("NS_HD void body"):src.index("NS_HD void decide")]
    # one statement per gate, every literal an unsigned 32-bit constant
    gates = [ln for ln in body.splitlines() if re.match(r"  (s\d+ =|cnt\[)", ln)]
    assert len(gates) == len(prog.code)
    assert all(lit.endswith("u") for lit in re.findall(r"0x[0-9A-F]+u?", body))
    assert "EMASK" not in body and "switch" not in body
