"""The SNE encoders' shared per-word body, compiled as host C++, against the plain
torch versions and the JAX reference.

``sne_encode/csrc/sne_body.h`` holds what the CUDA ``sne_encode`` and
``bayes_decide`` kernels run per entropy word: the hash with its keys folded
into 3-input XORs, the SWAR compare of 4 entropy bytes against a threshold
split at 128 (so that 256 needs no flag), the multiply and funnel shift that
pack, the levels 0 and 256 that need no hash (a ``bayes_decide`` stream
with a modality at 0 counts 0), and ``bayes_decide``'s per-thread share of a
stream and its argmax.
Here ``g++`` builds it with a host loop over every item of a launch -- every
(row, word) of ``sne_encode``, every (row, class, lane) of ``bayes_decide``
at the split its wrapper picks -- and its words, counts and decisions are
held bit for bit against ``ref.sne_encode_ref`` / ``ref.bayes_decide_ref``,
against ``repro.kernels.sne_encode`` / ``repro.kernels.bayes_decide`` (their
plain references and their Pallas kernels in interpret mode, as the JAX
package's tests run them on the CPU), on the same numpy-seeded inputs:
thresholds 0, 256 and the DAC half steps, n_bits 32 to 4096, M 1 to 3, K 1
to 33 with ties and all-zero rows, one row and rows off any block grid, and
counter origins and row counters past 2**32.  Tests that need ``g++`` skip,
inside the test, where there is none.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro.kernels.bayes_decide.kernel import bayes_decide_pallas
from repro.kernels.bayes_decide.ops import bayes_decide as jbayes_decide
from repro.kernels.bayes_decide.ref import bayes_decide_ref as jbayes_decide_ref
from repro.kernels.sne_encode.kernel import sne_encode_pallas
from repro.kernels.sne_encode.ops import sne_encode as jsne_encode
from repro.kernels.sne_encode.ref import sne_encode_ref as jsne_encode_ref
from repro_torch.core import rng
from repro_torch.kernels.bayes_decide import kernel as bd_kernel
from repro_torch.kernels.bayes_decide.ref import bayes_decide_ref
from repro_torch.kernels.sne_encode import kernel as sne_kernel
from repro_torch.kernels.sne_encode.ref import sne_encode_ref

torch.set_num_threads(1)

WRAP = 2**32 - 300         # a counter origin whose draws wrap 2**32
FILL = 132 * 2048          # threads that fill an H100: the split the card would take
# thresholds 0 and 256 (also clipped from outside [0, 1]) and the half steps
# (2k+1)/512, which round to even
EDGES = np.array([0.0, 1.0, 1.5, -0.25, 1 / 512, 3 / 512, 255 / 512, 257 / 512, 511 / 512],
                 np.float32)

# the kernels' item loops, on the host
HARNESS = r"""
extern "C" void encode(const float* p, long long n_rows, long long row0, int n_out,
                       uint32_t kd0, uint32_t kd1, uint32_t off, uint32_t* out) {
  const SneKey key = sne_key(kd0, kd1);
  const unsigned long long n_rand = 8ull * (unsigned long long)n_out;
  for (long long r = 0; r < n_rows; ++r) {
    const uint32_t level = sne_level(p[r]);
    const SneThr t = sne_threshold(p[r]);
    for (int w = 0; w < n_out; ++w) {
      out[r * n_out + w] = sne_constant(level)
          ? sne_constant_word(level)
          : sne_word(sne_first_counter(row0 + r, n_rand, w, off), t, key);
    }
  }
}

// rows row0 .. row0 + n_rows of a launch over rows_total rows; a dead or full
// stream is counted without a hash, and the split lanes' counts of the others
// are added as the kernel's shuffles add them
extern "C" void decide(const float* p, int n_mod, long long n_rows, long long rows_total,
                       long long row0, int n_cls, int n_out, int split, uint32_t kd0,
                       uint32_t kd1, uint32_t off, int* dec, int* counts) {
  const SneKey key = sne_key(kd0, kd1);
  const unsigned long long p_plane = (unsigned long long)n_rows * n_cls;
  const unsigned long long plane = (unsigned long long)rows_total * n_cls;
  for (long long r = 0; r < n_rows; ++r) {
    for (int k = 0; k < n_cls; ++k) {
      const int kind = sne_stream_kind(p + r * n_cls + k, p_plane, n_mod);
      int c = kind == SNE_FULL ? 32 * n_out : 0;
      for (int s = 0; kind == SNE_HASHED && s < split; ++s) {
        c += sne_stream_count(p + r * n_cls + k, p_plane, n_mod,
                              (unsigned long long)(row0 + r) * n_cls + k, plane, n_out, s,
                              split, key, off);
      }
      counts[r * n_cls + k] = c;
    }
    dec[r] = sne_argmax(counts + r * n_cls, n_cls);
  }
}
"""

_LIB = {}


def _host_library(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the SNE body as host C++")
    if "lib" not in _LIB:
        d = tmp_path_factory.mktemp("sne_body")
        (d / "body.cpp").write_text('#include "sne_body.h"\n' + HARNESS)
        subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                        str(sne_kernel.BODY.parent), "-o", str(d / "body.so"),
                        str(d / "body.cpp")], check=True, capture_output=True)
        lib = ctypes.CDLL(str(d / "body.so"))
        p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
        lib.encode.argtypes = [p, ll, ll, i, u, u, u, p]
        lib.decide.argtypes = [p, i, ll, ll, ll, i, i, i, u, u, u, p, p]
        _LIB["lib"] = lib
    return _LIB["lib"]


def _encode(lib, p, n_bits, kd, row0=0, offset=0):
    """The host build's (R, n_bits // 32) uint32 words of rows row0 .. row0 + R."""
    p = np.ascontiguousarray(p, np.float32)
    out = np.zeros((p.shape[0], n_bits // 32), np.uint32)
    lib.encode(p.ctypes.data, p.shape[0], row0, n_bits // 32, int(kd[0]), int(kd[1]),
               offset & 0xFFFFFFFF, out.ctypes.data)
    return out


def _decide(lib, p, n_bits, kd, split, rows_total=None, row0=0, offset=0):
    """The host build's (decisions (R,), counts (R, K)) int32 for p (M, R, K)."""
    p = np.ascontiguousarray(p, np.float32)
    m, rows, k = p.shape
    dec, counts = np.zeros(rows, np.int32), np.zeros((rows, k), np.int32)
    lib.decide(p.ctypes.data, m, rows, rows if rows_total is None else rows_total, row0, k,
               n_bits // 32, split, int(kd[0]), int(kd[1]), offset & 0xFFFFFFFF,
               dec.ctypes.data, counts.ctypes.data)
    return dec, counts


def _key(seed):
    """(JAX key, its (2,) uint32 key data) for one seed."""
    k = jax.random.PRNGKey(seed)
    return k, np.asarray(jax.random.key_data(k))


def _entropy(kd, shape, n_bits, offset):
    """(port int64, JAX uint32) entropy words at a counter origin, held equal."""
    offset &= 0xFFFFFFFF
    words = rng.counter_hash_words(kd, shape, n_bits // 4, offset=offset)
    jwords = np.asarray(jrng.counter_hash_words(jnp.asarray(kd), shape, n_bits // 4,
                                                offset=offset))
    np.testing.assert_array_equal(words.numpy(), jwords.astype(np.int64))
    return words, jwords


def _u32(words):
    return words.numpy().astype(np.int64).astype(np.uint32)


def _probs(seed, shape):
    """Uniform probabilities with EDGES spread over them."""
    r = np.random.default_rng(seed)
    p = r.random(shape).astype(np.float32)
    flat = p.reshape(-1)
    idx = r.permutation(flat.size)[: min(flat.size, EDGES.size)]
    flat[idx] = EDGES[r.permutation(EDGES.size)][: idx.size]
    return p


def _past(n_rand, k=1):
    """A row whose first counter, row * k * n_rand, lies past 2**33."""
    return (2**33 + 12345) // (k * n_rand) + 3


# (rows, first row, counter origin): one row, rows off any block grid at an
# origin that wraps 2**32, and rows whose row counters lie past 2**33
_ENC = [(1, 0, 0), (37, 0, WRAP), (5, "past", 0)]


@pytest.mark.parametrize("n_bits", [32, 128, 4096])
@pytest.mark.parametrize("rows,row0,offset", _ENC, ids=["one-row", "37-rows-wrap", "past-2^32"])
def test_host_encode_equals_plain_and_reference(n_bits, rows, row0, offset, tmp_path_factory):
    lib = _host_library(tmp_path_factory)
    jk, kd = _key(n_bits + rows)
    n_rand = n_bits // 4
    row0 = _past(n_rand) if row0 == "past" else row0
    p = _probs(n_bits + rows, (rows,))
    got = _encode(lib, p, n_bits, kd, row0, offset)
    rand, jrand = _entropy(kd, (rows,), n_bits, row0 * n_rand + offset)
    np.testing.assert_array_equal(got, _u32(sne_encode_ref(torch.from_numpy(p), rand)))
    np.testing.assert_array_equal(got, np.asarray(jsne_encode_ref(p, jrand)))
    np.testing.assert_array_equal(
        got, np.asarray(sne_encode_pallas(jnp.asarray(p), jnp.asarray(jrand), interpret=True)))
    if row0 == 0 and offset == 0:       # the JAX op draws its own words from the key
        np.testing.assert_array_equal(got, np.asarray(jsne_encode(jk, p, n_bits)))


def test_host_thresholds_split_at_128_and_256_is_always_one(tmp_path_factory):
    """Thresholds 0, 1, 127, 128, 129, 255, 256 (t / 256) against every
    entropy byte: a stream bit is 1 exactly where the byte lies below t."""
    lib = _host_library(tmp_path_factory)
    kd = np.array([0x85EBCA6B, 0x3C6EF372], np.uint32)
    n_bits, ts = 4096, (0, 1, 127, 128, 129, 255, 256)
    got = _encode(lib, np.array(ts, np.float32) / 256, n_bits, kd)
    rand = rng.counter_hash_words(kd, (len(ts),), n_bits // 4).numpy()
    for r, t in enumerate(ts):
        byte = (rand[r, :, None] >> (8 * np.arange(4))) & 0xFF       # (n_rand, 4)
        bits = (got[r, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        np.testing.assert_array_equal(bits.reshape(-1, 8, 4).reshape(-1, 4),
                                      (byte < t).astype(np.uint32))


# (n_bits, rows, first row, counter origin), one per (M, K) in turn
_DEC = [(32, 5, 0, 0), (128, 1, 0, WRAP), (4096, 3, "past", 0), (256, 7, 0, 2**32 - 5000)]


def _decide_probs(seed, m, rows, k):
    """(M, R, K) probabilities: EDGES spread over them; row 0 all zero (every
    class ties at count 0), and where there are rows and classes enough, row
    1 ties classes 1 and 2 at p = 1 in every modality (the rest at most 0.5)."""
    p = _probs(seed, (m, rows, k))
    if rows >= 2:
        p[:, 0] = 0.0
    if rows >= 3 and k >= 3:
        p[:, 1] = np.minimum(p[:, 1], 0.5)
        p[:, 1, 1:3] = 1.0
    return p


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 8, 16, 33])
def test_host_decide_equals_plain_and_reference(m, k, tmp_path_factory):
    lib = _host_library(tmp_path_factory)
    n_bits, rows, row0, offset = _DEC[(m + k) % len(_DEC)]
    jk, kd = _key(10 * m + k)
    n_rand = n_bits // 4
    row0 = _past(n_rand, k) if row0 == "past" else row0
    rows_total = row0 + rows + 11               # the launch's rows: the plane of a modality
    p = _decide_probs(m + k, m, rows, k)
    split, _, _ = bd_kernel.launch_split(rows_total, k, n_bits // 32, FILL)
    dec, counts = _decide(lib, p, n_bits, kd, split, rows_total, row0, offset)
    # each modality's (R, K) streams are contiguous at their own counter origin
    draws = [_entropy(kd, (rows, k), n_bits, ((mi * rows_total + row0) * k) * n_rand + offset)
             for mi in range(m)]
    rand = torch.stack([d[0] for d in draws])
    jrand = np.stack([d[1] for d in draws])
    want_dec, want_cnt = bayes_decide_ref(torch.from_numpy(p), rand)
    np.testing.assert_array_equal(counts, want_cnt.numpy())
    np.testing.assert_array_equal(dec, want_dec.numpy())
    for jdec, jcnt in (jbayes_decide_ref(p, jrand),
                       bayes_decide_pallas(jnp.asarray(p), jnp.asarray(jrand), interpret=True)):
        np.testing.assert_array_equal(counts, np.asarray(jcnt))
        np.testing.assert_array_equal(dec, np.asarray(jdec))
    if rows >= 2:                               # all-zero counts decide 0
        assert int(dec[0]) == 0 and int(counts[0].sum()) == 0
    if rows >= 3 and k >= 3:                    # the tie at n_bits goes to the lower class
        assert int(counts[1, 1]) == int(counts[1, 2]) == n_bits and int(dec[1]) == 1
    if row0 == 0 and offset == 0:               # the JAX op draws from the key over R rows
        jdec, jcnt = jbayes_decide(jk, p, n_bits)
        d0, c0 = _decide(lib, p, n_bits, kd, split)
        np.testing.assert_array_equal(c0, np.asarray(jcnt))
        np.testing.assert_array_equal(d0, np.asarray(jdec))


@pytest.mark.parametrize("n_bits", [96, 256, 4096])
def test_host_every_split_counts_the_same(n_bits, tmp_path_factory):
    """However many threads share a stream's words (1 up to 32, at most the
    word count, odd word counts included), the counts are the plain version's."""
    lib = _host_library(tmp_path_factory)
    kd = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)
    m, rows, k = 2, 4, 3
    p = _decide_probs(n_bits, m, rows, k)
    rand = rng.counter_hash_words(kd, (m, rows, k), n_bits // 4)
    want_dec, want_cnt = bayes_decide_ref(torch.from_numpy(p), rand)
    split = 1
    while split <= min(32, n_bits // 32):
        dec, counts = _decide(lib, p, n_bits, kd, split)
        np.testing.assert_array_equal(counts, want_cnt.numpy())
        np.testing.assert_array_equal(dec, want_dec.numpy())
        split *= 2


def test_host_decide_counts_constant_streams_without_a_hash(tmp_path_factory):
    """Streams with a modality at level 0 (count 0), with every modality at 256
    (count n_bits), and with 256 beside hashed modalities (skipped in the AND):
    the counts and decisions are the plain version's."""
    lib = _host_library(tmp_path_factory)
    kd = np.array([0x2545F497, 0x7F4A7C15], np.uint32)
    m, rows, k, n_bits = 3, 5, 4, 128
    p = _probs(77, (m, rows, k))
    p[0, 0, :] = 0.0                        # row 0: dead in every class ...
    p[1:, 0, :] = 0.7                       # ... though the others are hashed
    p[:, 1, 2] = 1.0                        # row 1: class 2 full, the top count
    p[:, 2, :] = [[1.0, 0.3, 1.2, 0.9]]     # row 2: 256 in every modality of 0 and 2
    p[0, 3, :] = 1.0                        # row 3: modality 0 at 256 beside hashed ones
    p[2, 4, 1] = 1 / 512                    # row 4: 1/512 rounds to level 0 (half to even)
    rand = rng.counter_hash_words(kd, (m, rows, k), n_bits // 4)
    want_dec, want_cnt = bayes_decide_ref(torch.from_numpy(p), rand)
    for split in (1, 2, 4):
        dec, counts = _decide(lib, p, n_bits, kd, split)
        np.testing.assert_array_equal(counts, want_cnt.numpy())
        np.testing.assert_array_equal(dec, want_dec.numpy())
    assert not counts[0].any() and int(counts[4, 1]) == 0
    assert int(counts[1, 2]) == n_bits and int(dec[1]) == 2
    assert int(counts[2, 0]) == int(counts[2, 2]) == n_bits and int(dec[2]) == 0


@pytest.mark.parametrize("residue", range(8))
def test_host_every_counter_origin_mod_8(residue, tmp_path_factory):
    """The hash's first step takes ctr0 ^ e for a word's 8 counters where they
    start at a multiple of 8, and the whole step elsewhere: at every residue of
    the counter origin mod 8, with counters that cross a multiple of 65536 and
    wrap 2**32, the words and counts are the plain versions'."""
    lib = _host_library(tmp_path_factory)
    kd = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)
    n_bits, m, rows, k = 128, 2, 12, 3
    n_rand = n_bits // 4
    for offset in (65536 - 200 + residue, 2**32 - 300 + residue):
        p = _probs(residue, (m * rows * k,))
        words = _encode(lib, p, n_bits, kd, 0, offset)
        rand = rng.counter_hash_words(kd, (m * rows * k,), n_rand, offset=offset)
        np.testing.assert_array_equal(words, _u32(sne_encode_ref(torch.from_numpy(p), rand)))
        p3 = p.reshape(m, rows, k)
        want_dec, want_cnt = bayes_decide_ref(torch.from_numpy(p3), rand.view(m, rows, k, -1))
        for split in (1, 2, 4):
            dec, counts = _decide(lib, p3, n_bits, kd, split, offset=offset)
            np.testing.assert_array_equal(counts, want_cnt.numpy())
            np.testing.assert_array_equal(dec, want_dec.numpy())


@pytest.mark.parametrize("rows,k,n_out,split,chunk,rows_per_tile", [
    (4096, 2, 4, 4, 1, 16),         # bench_latency's decision: 256 blocks of 128
    (16_588_800, 16, 4, 1, 8, 64),  # the full paper-bayes-fusion batch: 8 streams a thread
    (64, 8, 8, 8, 1, 2),            # a bayes_head batch: 64 tokens, top 8 classes, 256 bits
    (4, 8, 8, 8, 1, 2),             # the LM gate: B = 4, top 8 classes, 256 bits
    (2, 8, 8, 8, 1, 2),             # deepseek's MTP fusion: B = 2, top 8 classes, 256 bits
    (1, 1, 128, 32, 1, 4),          # one stream of 4096 bits: a warp shares it
    (100, 33, 4, 4, 1, 1),          # more threads per row than a block has
    (10_000, 200, 3, 1, 7, 4),      # three words, many classes
])
def test_launch_split_fills_the_card(rows, k, n_out, split, chunk, rows_per_tile):
    assert bd_kernel.launch_split(rows, k, n_out, FILL) == (split, chunk, rows_per_tile)
    assert bd_kernel.THREADS // split * chunk <= 1024          # the kernel's queue
    blocks = -(-rows // rows_per_tile)
    if rows * k * n_out >= 132 * bd_kernel.THREADS:     # enough words for a block per SM
        assert blocks >= 132 or rows * k * split >= FILL
