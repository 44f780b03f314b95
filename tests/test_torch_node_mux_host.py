"""The binary ``node_mux`` kernels' per-word bodies, compiled as host C++, against
the plain torch versions and the JAX reference.

``csrc/node_mux_body.h`` holds what the CUDA gather and row-encode kernels run
per output word: the nibble selectors built from whole parent words, the
threshold bytes fetched with byte permutes (``__byte_perm``, defined for the
host in the header), the SWAR compare and the multiply that packs.  Here
``g++`` builds it with a host loop over every (row, word) item of a launch,
and its words are held bit for bit against ``ref.node_mux_gather_ref`` /
``ref.node_mux_ref`` and against ``repro.kernels.node_mux.ref`` on the same
numpy-seeded inputs: 0 to 6 parents, thresholds 0, 256 and the DAC half
steps, one table per row and one shared table, counter origins whose draws
wrap 2**32, and both row-encode forms.  Tests that need ``g++`` skip, inside
the test, where there is none.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro.kernels.node_mux import ref as jref
from repro_torch.core import rng
from repro_torch.kernels.node_mux import kernel, ref

torch.set_num_threads(1)

WRAP = 2**32 - 300         # a counter origin whose draws wrap 2**32
# every m's tables hold these: 0 and 256 (clipped from outside [0, 1] too)
# and the half steps (2k+1)/512, which round to even
EDGES = np.array([0.0, 1.0, 1 / 512, 3 / 512, 255 / 512, 257 / 512, 511 / 512, 1.5, -0.25],
                 np.float32)

# the kernel's item loop, on the host; mode 0 gather, 1 rows (every row's
# words), 2 rows (only the selected rows' words)
HARNESS = r"""
template <int M, int MODE>
static void run_m(const float* cpt, long long stride, const uint32_t* par, uint32_t* out,
                  long long n_rows, int n_out, uint32_t kd0, uint32_t kd1, uint32_t off) {
  for (long long r = 0; r < n_rows; ++r) {
    const NmThr<M> t = nm_thresholds<M>(cpt + r * stride);
    for (int w = 0; w < n_out; ++w) {
      out[r * n_out + w] =
          MODE == 0 ? nm_gather_item<M>(t, par, n_rows, n_out, r, w, kd0, kd1, off)
                    : nm_rows_item<M, MODE == 2>(t, par, n_rows, n_out, r, w, kd0, kd1, off);
    }
  }
}

template <int M>
static void run_mode(int mode, const float* cpt, long long stride, const uint32_t* par,
                     uint32_t* out, long long n_rows, int n_out, uint32_t kd0, uint32_t kd1,
                     uint32_t off) {
  if (mode == 0) run_m<M, 0>(cpt, stride, par, out, n_rows, n_out, kd0, kd1, off);
  if (mode == 1) run_m<M, 1>(cpt, stride, par, out, n_rows, n_out, kd0, kd1, off);
  if (mode == 2) run_m<M, 2>(cpt, stride, par, out, n_rows, n_out, kd0, kd1, off);
}

extern "C" int rows_selected(int m) { return nm_rows_selected(m) ? 1 : 0; }

extern "C" void run(int mode, int m, const float* cpt, long long stride, const uint32_t* par,
                    uint32_t* out, long long n_rows, int n_out, uint32_t kd0, uint32_t kd1,
                    uint32_t off) {
  switch (m) {
    case 0: run_mode<0>(mode, cpt, stride, par, out, n_rows, n_out, kd0, kd1, off); break;
    case 1: run_mode<1>(mode, cpt, stride, par, out, n_rows, n_out, kd0, kd1, off); break;
    case 2: run_mode<2>(mode, cpt, stride, par, out, n_rows, n_out, kd0, kd1, off); break;
    case 3: run_mode<3>(mode, cpt, stride, par, out, n_rows, n_out, kd0, kd1, off); break;
    case 4: run_mode<4>(mode, cpt, stride, par, out, n_rows, n_out, kd0, kd1, off); break;
    case 5: run_mode<5>(mode, cpt, stride, par, out, n_rows, n_out, kd0, kd1, off); break;
    default: run_mode<6>(mode, cpt, stride, par, out, n_rows, n_out, kd0, kd1, off); break;
  }
}
"""

_LIB = {}


def _host_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the node_mux bodies as host C++")
    if "lib" not in _LIB:
        d = tmp_path_factory.mktemp("node_mux_body")
        (d / "body.cpp").write_text('#include "node_mux_body.h"\n' + HARNESS)
        subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                        str(kernel.SOURCE.parent), "-o", str(d / "body.so"), str(d / "body.cpp")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(d / "body.so"))
        lib.run.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                            + [ctypes.c_uint] * 3)
        _LIB["lib"] = lib
    return _LIB["lib"]


def _host(lib, mode, cpt, stride, par, kd, offset):
    """The host build's (R, W) uint32 words: cpt float32 (rows of 2**m, row
    stride ``stride``), par (m, R, W) uint32."""
    m, rows, n_out = par.shape
    par = np.ascontiguousarray(par if m else np.zeros((1, rows, n_out), np.uint32))
    out = np.zeros((rows, n_out), np.uint32)
    lib.run(mode, m, cpt.ctypes.data, stride, par.ctypes.data, out.ctypes.data, rows, n_out,
            int(kd[0]), int(kd[1]), offset & 0xFFFFFFFF)
    return out


def _cpt(seed, rows, m):
    """(rows, 2**m) float32 CPT rows with EDGES spread over them, so that every
    row of a shared table and every m sees 0, 256 and the half steps."""
    r = np.random.default_rng(seed)
    cpt = r.random((rows, 1 << m)).astype(np.float32)
    flat = cpt.reshape(-1)
    idx = r.permutation(flat.size)[: min(flat.size, 3 * EDGES.size)]
    flat[idx] = np.resize(EDGES, idx.size)
    cpt[0] = np.resize(EDGES[r.permutation(EDGES.size)], 1 << m)
    return cpt


def _entropy(kd, shape, n_bits, offset):
    """(port int64, JAX uint32) entropy words at a counter origin."""
    words = rng.counter_hash_words(kd, shape, n_bits // 4, offset=offset)
    jwords = np.asarray(jrng.counter_hash_words(jnp.asarray(kd), shape, n_bits // 4,
                                                offset=offset))
    np.testing.assert_array_equal(words.numpy(), jwords.astype(np.int64))
    return words, jnp.asarray(jwords)


def _u32(words):
    return np.asarray(words.numpy() if isinstance(words, torch.Tensor) else words).astype(
        np.int64).astype(np.uint32)


@pytest.mark.parametrize("m", range(7))
@pytest.mark.parametrize("shared", [False, True], ids=["per-row", "shared"])
@pytest.mark.parametrize("rows,n_bits,offset", [(6, 64, 0), (3, 128, WRAP)])
def test_host_bodies_equal_plain_and_reference(m, shared, rows, n_bits, offset,
                                               tmp_path_factory):
    lib = _host_library(tmp_path_factory)
    kd = np.array([0x9E3779B9, 0x2545F497 + 7 * m], np.uint32)
    table = _cpt(m + 10 * shared, 1 if shared else rows, m)
    cpt = np.array(np.broadcast_to(table, (rows, 1 << m)))
    par = np.random.default_rng(m + 1).integers(0, 2**32, (m, rows, n_bits // 32),
                                                dtype=np.uint64).astype(np.uint32)
    tcpt, tpar = torch.from_numpy(cpt), torch.from_numpy(par.view(np.int32))
    jcpt, jpar = jnp.asarray(cpt), jnp.asarray(par)
    stride = 0 if shared else 1 << m

    rand, jrand = _entropy(kd, (rows,), n_bits, offset)
    got = _host(lib, 0, table, stride, par, kd, offset)
    np.testing.assert_array_equal(got, _u32(ref.node_mux_gather_ref(tcpt, rand, tpar)))
    np.testing.assert_array_equal(got, np.asarray(jref.node_mux_gather_ref(jcpt, jrand, jpar)))

    rand, jrand = _entropy(kd, (rows, 1 << m), n_bits, offset)
    want = _u32(ref.node_mux_ref(tcpt, rand, tpar))
    np.testing.assert_array_equal(want, np.asarray(jref.node_mux_ref(jcpt, jrand, jpar)))
    for mode in (1, 2):                  # every row's words, only the selected rows'
        np.testing.assert_array_equal(_host(lib, mode, table, stride, par, kd, offset), want)


def test_host_thresholds_split_at_128_and_256_is_always_one(tmp_path_factory):
    """Thresholds 127, 128, 129, 255, 256 (t / 256) against every byte value:
    a stream bit is 1 exactly where the entropy byte lies below t."""
    lib = _host_library(tmp_path_factory)
    kd = np.array([0x85EBCA6B, 0x3C6EF372], np.uint32)
    n_bits, rows = 4096, 5
    cpt = np.array([[127 / 256], [128 / 256], [129 / 256], [255 / 256], [1.0]], np.float32)
    got = _host(lib, 0, cpt, 1, np.zeros((0, rows, n_bits // 32), np.uint32), kd, 0)
    rand = rng.counter_hash_words(kd, (rows,), n_bits // 4).numpy()
    for r, t in enumerate((127, 128, 129, 255, 256)):
        byte = (rand[r, :, None] >> (8 * np.arange(4))) & 0xFF       # (n_rand, 4)
        bits = (got[r, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        np.testing.assert_array_equal(bits.reshape(-1, 8, 4).reshape(-1, 4),
                                      (byte < t).astype(np.uint32))


def test_rows_form_follows_the_parent_count(tmp_path_factory):
    """Every row's words where L <= 2, only the selected rows' above."""
    lib = _host_library(tmp_path_factory)
    assert [lib.rows_selected(m) for m in range(7)] == [0, 0, 1, 1, 1, 1, 1]
