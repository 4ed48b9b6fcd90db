"""What the text-to-wav CLIs share (the twins of the FastSpeech2,
SpeedySpeech and TransformerTTS ``synthesize_e2e.py`` and of
``tools/serve.py``): the flags of the JAX CLIs that the port refuses, the
``<utt_id> <sentence>`` reader, the acoustic model's program at one static
text shape, and the card's float32 setting.

An acoustic model's program reads a (1, ``max_text_len``) id buffer (and
its length, tones or speaker) that every line is copied into; on the card
it is one CUDA graph (``utils/graphs.py::CapturedProgram``), captured once
and replayed for every line, as the JAX CLIs jit it once; on the CPU it
runs eagerly.  The vocoders run eagerly on each line's frames: the mel's
length changes with every line.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..data.preprocess import build_phone_id_map, build_phone_tone_id_maps
from ..frontend import ARPABET_PHONES, generate_lexicon
from ..utils.graphs import CapturedProgram

__all__ = ["add_unported_args", "refuse_unported", "read_sentences",
           "TextProgram", "sync", "Stopwatch", "write_id_maps"]


def add_unported_args(parser, sp: bool = True) -> None:
    """The JAX CLIs' ``--export-dir`` (and ``--sp``), which the port
    parses only to refuse them (``refuse_unported``)."""
    parser.add_argument("--export-dir", default=None,
                        help="not ported: jax.export's serialized graphs "
                             "become torch.export's (ROADMAP queue 1, item "
                             "17)")
    if sp:
        parser.add_argument("--sp", type=int, default=1,
                            help="not ported above 1: sequence parallelism "
                                 "(ROADMAP queue 1, item 18)")


def refuse_unported(args) -> None:
    """Raise ``SystemExit`` on a flag the port does not run, naming the
    ROADMAP item that ports it; nothing is accepted and then ignored."""
    if args.export_dir is not None:
        raise SystemExit("--export-dir is not ported: the serialized graphs "
                         "(jax.export -> torch.export) and inference.py wait "
                         "for ROADMAP queue 1, item 17")
    if getattr(args, "sp", 1) > 1:
        raise SystemExit(f"--sp {args.sp} is not ported: sequence "
                         "parallelism waits for ROADMAP queue 1, item 18")


def write_id_maps(out_dir, lang: str) -> Dict[str, Path]:
    """The id maps of every phone the text frontend of ``lang`` can emit,
    written as the recipes' preprocessing writes them
    (``data/preprocess.py``) into ``out_dir``: for "zh" the toned phones
    of the rule-generated lexicon and the sentence pause "sp", in
    ``phone_id_map.txt`` and, tones split off, in ``tone_phone_id_map.txt``
    and ``tone_id_map.txt``; for "en" the ARPABET phones.  Returns the
    paths by name ("phones", and for "zh" "tone_phones", "tones")."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if lang == "zh":
        lexicon = generate_lexicon(with_tone=True, with_erhua=True)
        phones = sorted({p for v in lexicon.values() for p in v.split()}
                        | {"sp"})
        dataset = "baker"
    elif lang == "en":
        phones, dataset = list(ARPABET_PHONES), "ljspeech"
    else:
        raise ValueError(f"no phone set for lang {lang!r}")
    sentences = {"all": [phones, [1] * len(phones), "0"]}
    paths = {"phones": out_dir / "phone_id_map.txt"}
    build_phone_id_map(sentences, paths["phones"], dataset)
    if lang == "zh":
        paths["tone_phones"] = out_dir / "tone_phone_id_map.txt"
        paths["tones"] = out_dir / "tone_id_map.txt"
        build_phone_tone_id_maps(sentences, paths["tone_phones"],
                                 paths["tones"], dataset)
    return paths


def read_sentences(path) -> List[Tuple[str, str]]:
    """(utt_id, sentence) of each ``<utt_id> <sentence>`` line; blank and
    malformed lines are skipped."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                out.append((parts[0], parts[1]))
            elif parts:
                print(f"skipping malformed line: {line.strip()!r}")
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stopwatch:
    """Host-clock seconds between synchronisations of ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        sync(device)
        self.start = time.perf_counter()

    def seconds(self) -> float:
        sync(self.device)
        return time.perf_counter() - self.start


class TextProgram:
    """``fn(**inputs)`` over static inputs whose ``text`` is (1,
    ``max_text_len``) int64 ids (zero-padded) and whose optional
    ``text_lengths`` and ``tones`` go with it; the other inputs (speaker,
    dropout masks) stay as given.  One CUDA graph when ``graph`` (the
    inputs on the card), else eager."""

    def __init__(self, fn: Callable, inputs: Dict[str, torch.Tensor],
                 graph: bool):
        self.fn, self.inputs = fn, inputs
        self.max_text_len = inputs["text"].shape[1]
        self.load([1])                  # a valid line for the capture's runs
        self.program = CapturedProgram(fn, inputs) if graph else None

    def load(self, ids: Sequence[int],
             tones: Optional[Sequence[int]] = None) -> None:
        """Copy a line's ids (and tones), cut to ``max_text_len``, into the
        inputs."""
        n = min(len(ids), self.max_text_len)
        for name, seq in (("text", ids), ("tones", tones)):
            if name in self.inputs:
                row = torch.zeros((1, self.max_text_len), dtype=torch.int64)
                if seq is not None:
                    row[0, :n] = torch.as_tensor(list(seq[:n]),
                                                 dtype=torch.int64)
                self.inputs[name].copy_(row)
        if "text_lengths" in self.inputs:
            self.inputs["text_lengths"].fill_(n)

    @torch.no_grad()
    def eager(self):
        """The program's outputs on the loaded line, eagerly."""
        return self.fn(**self.inputs)

    def __call__(self, ids: Sequence[int],
                 tones: Optional[Sequence[int]] = None):
        """The outputs on ``ids``: a replay of the graph, or eager."""
        self.load(ids, tones)
        if self.program is None:
            return self.eager()
        return self.program()
