"""What the text-to-wav CLIs share (the twins of the FastSpeech2,
SpeedySpeech and TransformerTTS ``synthesize_e2e.py``, of their
``inference.py`` and of ``tools/serve.py``): the ``--export-dir`` and
``--sp`` flags (``--sp`` above 1 refused), the ``<utt_id> <sentence>``
reader, the acoustic model's program at one static text shape, and the
programs that ``--export-dir`` writes and ``inference.py`` reads.

An acoustic model's program reads a (1, ``max_text_len``) id buffer (and
its length, tones or speaker) that every line is copied into; on the card
it is one CUDA graph (``utils/graphs.py::CapturedProgram``), captured once
and replayed for every line, as the JAX CLIs jit it once; on the CPU it
runs eagerly.  The vocoders run eagerly on each line's frames: the mel's
length changes with every line.

An exported program is a ``torch.export`` program saved as
``<name>.pt2`` with its record (``EXPORT_RECORD``: the device it was
made for, its input shapes) inside the archive.  It is loaded only on
the device it was made for, never moved; loading needs K1's operator
registered, which importing this module does.
"""
from __future__ import annotations

import json
import time
import zipfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..data.preprocess import build_phone_id_map, build_phone_tone_id_maps
from ..frontend import ARPABET_PHONES, generate_lexicon
from ..ops.kernels import pwg_stack  # noqa: F401  registers K1's operator
from ..utils.graphs import CapturedProgram

__all__ = ["add_deploy_args", "refuse_unported", "read_sentences",
           "TextProgram", "sync", "Stopwatch", "write_id_maps",
           "save_export", "export_record", "load_exports", "EXPORT_RECORD",
           "ExportedSpeech"]

# the name of an exported program's record inside its .pt2 archive
EXPORT_RECORD = "parakeet_export.json"


def add_deploy_args(parser, sp: bool = True) -> None:
    """The JAX CLIs' ``--export-dir`` (and ``--sp``, which the port parses
    only to refuse it above 1, ``refuse_unported``)."""
    parser.add_argument("--export-dir", type=Path, default=None,
                        help="also write the acoustic model and the "
                             "vocoder as torch.export programs (.pt2) for "
                             "inference.py, made for --device (requires "
                             "--pwg-checkpoint)")
    if sp:
        parser.add_argument("--sp", type=int, default=1,
                            help="not ported above 1: sequence parallelism "
                                 "(ROADMAP queue 1, item 18)")


def refuse_unported(args) -> None:
    """Raise ``SystemExit`` on a flag the port does not run, naming the
    ROADMAP item that ports it; nothing is accepted and then ignored."""
    if getattr(args, "sp", 1) > 1:
        raise SystemExit(f"--sp {args.sp} is not ported: sequence "
                         "parallelism waits for ROADMAP queue 1, item 18")


def save_export(path, exported, device: torch.device, **record) -> None:
    """Save the ``torch.export`` program ``exported`` to ``path`` with its
    record: ``device`` (its type) and the keyword fields."""
    torch.export.save(exported, path, extra_files={
        EXPORT_RECORD: json.dumps({"device": device.type, **record})})


def export_record(path) -> dict:
    """The record inside an exported program's archive, read without
    loading the program; ``SystemExit`` when it has none."""
    with zipfile.ZipFile(path) as archive:
        names = [n for n in archive.namelist()
                 if n.rsplit("/", 1)[-1] == EXPORT_RECORD]
        if not names:
            raise SystemExit(f"{path} holds no {EXPORT_RECORD}: it was not "
                             "written by the port's synthesize_e2e.py "
                             "--export-dir")
        return json.loads(archive.read(names[0]))


def load_exports(export_dir, names: Sequence[str], device: torch.device
                 ) -> List[Tuple[torch.nn.Module, dict]]:
    """(module, record) of ``<export_dir>/<name>.pt2`` for each name.
    Raises ``SystemExit`` when one is missing (naming jax.export's
    ``.jaxexport`` files where the directory holds only those) or was made
    for another device than ``device``: an exported program is never
    moved."""
    export_dir = Path(export_dir)
    paths = [export_dir / f"{name}.pt2" for name in names]
    missing = [p.name for p in paths if not p.is_file()]
    if missing:
        jax_files = sorted(p.name for p in export_dir.glob("*.jaxexport"))
        if jax_files:
            raise SystemExit(
                f"{export_dir} holds jax.export's serialized graphs "
                f"({', '.join(jax_files)}), not the port's "
                f"{', '.join(missing)}: the port runs torch.export "
                "programs; export with the port's synthesize_e2e.py "
                "--export-dir")
        raise SystemExit(f"{export_dir} has no {', '.join(missing)}: "
                         "export with the port's synthesize_e2e.py "
                         "--export-dir")
    out = []
    for path in paths:
        record = export_record(path)
        if record.get("device") != device.type:
            raise SystemExit(
                f"{path} was exported for {record.get('device')!r}, not "
                f"{device.type!r}: an exported program holds its "
                "parameters and kernels on the device it was made for and "
                "is not moved; export again with synthesize_e2e.py "
                f"--export-dir --device {device.type}")
        out.append((torch.export.load(path).module(), record))
    return out


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


class ExportedSpeech:
    """The exported acoustic program and vocoder of ``load_exports``
    (``exports``: [(acoustic module, record), (vocoder module, record)])
    as ``inference.py`` runs them: ``(utt_id, ids, tones=None)`` -> {utt_id,
    ids, frames, samples, am_s, vocoder_s, mel, wav} (numpy; None when
    the program predicts no frame).  The acoustic program takes the (1,
    ``max_text_len``) buffers ``input_names`` ("text" and "text_lengths"
    or "tones") through a ``TextProgram`` (one CUDA graph on the card);
    the vocoder runs eagerly on the whole mel and one noise (1,
    max_frames * hop, 1), drawn once from a generator on ``device``
    seeded ``noise_seed``, and its wav is cut to the frames."""

    def __init__(self, exports, input_names: Sequence[str],
                 device: torch.device, noise_seed: int = 0):
        (am, am_record), (voc, voc_record) = exports
        self.voc, self.device = voc, device
        self.max_text_len = am_record["max_text_len"]
        self.hop, self.max_frames = voc_record["hop"], voc_record["max_frames"]
        inputs = {name: torch.zeros(
            (1,) if name == "text_lengths" else (1, self.max_text_len),
            dtype=torch.int64, device=device) for name in input_names}

        def run(**buffers):
            return am(*(buffers[name] for name in input_names))

        self.program = TextProgram(run, inputs, graph=device.type == "cuda")
        self.noise = torch.randn(
            (1, self.max_frames * self.hop, 1), device=device,
            generator=torch.Generator(device=device).manual_seed(noise_seed))

    def __call__(self, utt_id: str, ids: Sequence[int],
                 tones: Optional[Sequence[int]] = None) -> Optional[dict]:
        clock = Stopwatch(self.device)
        mel, frames = self.program(ids, tones)
        n = int(frames[0])
        am_s = clock.seconds()
        if n == 0:
            print(f"{utt_id}: predicted 0 frames, skipping")
            return None
        clock = Stopwatch(self.device)
        with torch.no_grad():
            wav = self.voc(mel, self.noise)[0, :n * self.hop]
        wav = wav.float().cpu().numpy()
        vocoder_s = clock.seconds()
        print(f"{utt_id}: {n} frames (AM {1e3 * am_s:.1f} ms, vocoder "
              f"{1e3 * vocoder_s:.1f} ms)")
        return {"utt_id": utt_id, "ids": list(ids), "frames": n,
                "samples": len(wav), "am_s": am_s, "vocoder_s": vocoder_s,
                "mel": mel[0, :n].float().cpu().numpy(), "wav": wav}
