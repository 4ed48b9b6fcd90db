"""Data pipeline of the port (counterpart of ``parakeet_tpu.data``): the
metadata table, batch sampling with a prefetching loader, the acoustic
models' bucketed batches, the vocoder's random clip, the dataset
combinators and audio-corpus datasets, and the corpus preprocessing
helpers (duration files, id maps, running statistics, TextGrid
durations).  Host-side numpy, as in the JAX package."""
from .collate import (VocoderClip, fastspeech2_batch_fn,
                      speedyspeech_batch_fn, transformer_tts_batch_fn)
from .dataloader import BatchSampler, DataLoader
from .dataset import (CacheDataset, ChainDataset, DictDataset, FilterDataset,
                      SliceDataset, SubsetDataset, TransformDataset,
                      TupleDataset, split)
from .datasets import (AudioDataset, AudioFolderDataset, AudioSegmentDataset,
                       LJSpeechMetaData)
from .datatable import DataTable, read_jsonl, write_jsonl
from .preprocess import (RunningStats, build_phone_id_map,
                         build_phone_tone_id_maps, build_spk_id_map,
                         cut_silence, load_id_map, merge_silence,
                         read_duration_file, reconcile_durations)
from .textgrid import (gen_duration_from_textgrid, parse_textgrid,
                       textgrid_to_durations)

__all__ = ["DataTable", "read_jsonl", "write_jsonl", "BatchSampler",
           "DataLoader", "VocoderClip", "split", "TransformDataset",
           "CacheDataset", "TupleDataset", "DictDataset", "SliceDataset",
           "SubsetDataset", "FilterDataset", "ChainDataset", "AudioDataset",
           "AudioSegmentDataset", "AudioFolderDataset", "LJSpeechMetaData", "fastspeech2_batch_fn",
           "speedyspeech_batch_fn", "transformer_tts_batch_fn",
           "read_duration_file", "merge_silence", "cut_silence",
           "build_phone_id_map", "build_phone_tone_id_maps",
           "build_spk_id_map", "load_id_map", "reconcile_durations",
           "RunningStats", "parse_textgrid", "textgrid_to_durations",
           "gen_duration_from_textgrid"]
