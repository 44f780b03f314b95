"""Core library: the paper's contribution as composable torch modules.

Bit words and entropy (``bitops``, ``rng``, ``prng``), the device model
(``device``), the SNEs (``sne``), probabilistic logic (``logic``),
correlation metrics (``correlation``), CORDIV (``cordiv``), the inference and
fusion operators (``inference``, ``graph``, ``fusion``) and the latency model
(``latency``); the names the reference's ``repro.core`` exports, name for
name.  Functions that draw take ``device=`` (default ``"cuda"``); functions
of streams run on the streams' device.
"""

from repro_torch.core import bitops, cordiv, correlation, device, fusion, graph, inference, latency, logic, prng, rng, sne  # noqa: F401,E501
from repro_torch.core.cordiv import cordiv_fill, cordiv_ratio, cordiv_scan, make_superset  # noqa: F401
from repro_torch.core.device import DEFAULT_PARAMS, MemristorParams, wear_scale  # noqa: F401
from repro_torch.core.fusion import bayes_fusion, detection_fusion, fuse_analytic  # noqa: F401
from repro_torch.core.inference import analytic_posterior, bayes_inference, bayes_inference_marginal  # noqa: F401,E501
from repro_torch.core.logic import Corr, prob_and, prob_mux, prob_or, prob_xor  # noqa: F401
from repro_torch.core.sne import encode_correlated, encode_uncorrelated, encode_via_device  # noqa: F401
