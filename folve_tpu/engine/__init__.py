"""Device engine: partitioned FFT convolution as pure JAX state-in/state-out."""

from folve_tpu.engine.constants import (
    MAXINP,
    MAXOUT,
    MAXSIZE,
    MINPART,
    MAXQUANT,
    derive_fragm,
    num_partitions,
)
from folve_tpu.engine.filter_bank import FilterBank, compile_filter_bank
from folve_tpu.engine.stream import (
    StreamState,
    batched_chunk_step,
    block_step,
    chunk_step,
    init_state,
    reset_state,
    shared_filter_chunk_step,
)

__all__ = [
    "MAXINP",
    "MAXOUT",
    "MAXSIZE",
    "MINPART",
    "MAXQUANT",
    "derive_fragm",
    "num_partitions",
    "FilterBank",
    "compile_filter_bank",
    "StreamState",
    "batched_chunk_step",
    "block_step",
    "chunk_step",
    "init_state",
    "reset_state",
    "shared_filter_chunk_step",
]
