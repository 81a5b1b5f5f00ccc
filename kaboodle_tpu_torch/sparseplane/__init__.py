"""Blocked-sparse membership planes for million-peer worlds.

The port of ``kaboodle_tpu/sparseplane``. The dense engines keep the
``[N, N]`` formulation; this package holds its ``blocked_topk`` twin: each
row's membership view lives in a ``[N, K]`` top-K-neighbor block (int32
neighbor-index plane + int8 state plane + timer plane), and every uniform
draw is counter-based threefry keyed ``(seed, cursor, stream, row, slot)``,
so no ``[N, N]`` tensor is ever made. The tick equals the JAX package's
bit for bit (tests/test_torch_sparseplane.py); parity with the dense
oracle is distributional, as in the JAX package.
"""

from kaboodle_tpu_torch.sparseplane.state import (
    SparseSpec,
    SparseState,
    SparseTickInputs,
    SparseTickMetrics,
    init_sparse_state,
    sparse_idle_inputs,
    sparse_fingerprint,
)
from kaboodle_tpu_torch.sparseplane.kernel import make_sparse_tick_fn
from kaboodle_tpu_torch.sparseplane.rng import (
    STREAM_ACK,
    STREAM_CHAIN,
    STREAM_DRAW,
    STREAM_GOSSIP,
    STREAM_PING,
    STREAM_PROXY,
    stream_table,
)
from kaboodle_tpu_torch.sparseplane.runner import (
    simulate_sparse,
    run_sparse_until_converged,
)

__all__ = [
    "STREAM_ACK",
    "STREAM_CHAIN",
    "STREAM_DRAW",
    "STREAM_GOSSIP",
    "STREAM_PING",
    "STREAM_PROXY",
    "stream_table",
    "SparseSpec",
    "SparseState",
    "SparseTickInputs",
    "SparseTickMetrics",
    "init_sparse_state",
    "sparse_idle_inputs",
    "sparse_fingerprint",
    "make_sparse_tick_fn",
    "simulate_sparse",
    "run_sparse_until_converged",
]
