"""Data pipeline of the port (counterpart of ``parakeet_tpu.data``): the
metadata table, batch sampling with a prefetching loader, the acoustic
models' bucketed batches and the vocoder's random clip.  Host-side numpy,
as in the JAX package."""
from .collate import VocoderClip, fastspeech2_batch_fn, speedyspeech_batch_fn
from .dataloader import BatchSampler, DataLoader
from .datatable import DataTable, read_jsonl, write_jsonl

__all__ = ["DataTable", "read_jsonl", "write_jsonl", "BatchSampler",
           "DataLoader", "VocoderClip", "fastspeech2_batch_fn",
           "speedyspeech_batch_fn"]
