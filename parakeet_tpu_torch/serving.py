"""Batched TTS serving engine (counterpart of ``parakeet_tpu/serving.py``).

Requests are quantized onto a grid of (text bucket, batch bucket) shapes,
padded into them and trimmed back per utterance, exactly as in the JAX
engine:

- text buckets bound the phone-id axis (smallest bucket >= len(ids)); each
  implies a static decoder capacity (``frames_per_token`` x bucket);
- batch buckets bound the batch axis; a group of same-bucket requests is
  cut into chunks of the largest batch bucket, each padded up to the
  smallest bucket that fits (pad rows are 1-token dummy utterances);
- requests longer than the largest text bucket are split at pause tokens
  (``split_ids``, else a hard cut) and the segment wavs stitched back.

Each chunk runs FastSpeech2 inference -> edge clamp of the frames past
each row's length -> denorm -> vocoder z-norm -> edge pad -> Parallel
WaveGAN.  With ``graphs`` (the default for models on a CUDA device) each
(text bucket, batch bucket) grid point is one CUDA graph, captured at its
first use (``utils/graphs.py``), the counterpart of the JAX engine's one
jitted program per grid point: a chunk fills the graph's static inputs,
replays it and copies wav and frame lengths to the host once.  The
graphs share one memory pool for their intermediates and never run
concurrently; each copies its results into buffers of its own, outside
the pool, so another grid point's replay cannot overwrite them.
Without graphs the same program runs eagerly, launch by launch; it is
the graphs' reference.

A request's noise comes from a ``torch.Generator`` seeded by its seed
alone, never its batch slot, so batching cannot change its noise.  The
generator differs from JAX's, so the port's wavs are not the JAX
engine's numbers.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.parallel_wavegan import edge_pad
from .utils.graphs import CapturedProgram

__all__ = ["Request", "Result", "TTSEngine"]


@dataclasses.dataclass
class Request:
    """One synthesis request: already-frontended phone ids + a seed."""
    ids: Sequence[int]
    utt_id: str = ""
    seed: int = 0
    spk_id: int = 0


@dataclasses.dataclass
class Result:
    """Per-request output: trimmed wav (or mel when the engine has no
    vocoder), in the same order as the requests."""
    utt_id: str
    wav: Optional[np.ndarray]  # (n_samples,) when the engine vocodes
    mel: Optional[np.ndarray]  # (n_frames, odim) when it does not
    n_frames: int


class TTSEngine:
    """Batched synthesis over a (text, batch) bucket grid.

    Args:
        am: port ``FastSpeech2`` (weights loaded, on its device).
        voc: optional port ``PWGGenerator`` on the same device; omitted,
            the engine returns mels.
        am_norm / voc_norm: optional ``ZScore`` pair: AM output denorm and
            vocoder-domain renorm.
        text_buckets / batch_buckets: ascending capacity grids.
        frames_per_token: decoder capacity per text slot.
        min_duration: floor of each valid token's predicted duration.
        multi_speaker: pass each request's spk_id into the AM.
        overflow: "split" (default), "truncate" or "error" for requests
            longer than the largest text bucket.
        split_ids: phone ids that mark pause points, preferred segment
            ends when splitting.
        graphs: one captured CUDA graph per grid point (default: when the
            models are on a CUDA device); True with models elsewhere
            raises.  False runs each chunk eagerly.

    The normalizers' statistics are moved to the models' device once,
    here, never per call.
    """

    def __init__(self, am, *, voc=None, am_norm=None, voc_norm=None,
                 text_buckets: Sequence[int] = (32, 64, 128),
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 frames_per_token: int = 8, min_duration: int = 1,
                 multi_speaker: bool = False, overflow: str = "split",
                 split_ids: Sequence[int] = (),
                 graphs: Optional[bool] = None):
        if list(text_buckets) != sorted(set(text_buckets)):
            raise ValueError(f"text_buckets must be ascending/unique: "
                             f"{text_buckets}")
        if list(batch_buckets) != sorted(set(batch_buckets)):
            raise ValueError(f"batch_buckets must be ascending/unique: "
                             f"{batch_buckets}")
        if overflow not in ("split", "truncate", "error"):
            raise ValueError(f"overflow must be split|truncate|error, "
                             f"got {overflow!r}")
        self.device = next(am.parameters()).device
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs the models on a CUDA "
                             f"device; they are on {self.device}")
        self.graphs = graphs
        self.am, self.voc = am, voc
        self.am_norm = None if am_norm is None else am_norm.to(self.device)
        self.voc_norm = (None if voc_norm is None
                         else voc_norm.to(self.device))
        self.text_buckets = tuple(text_buckets)
        self.batch_buckets = tuple(batch_buckets)
        self.frames_per_token = frames_per_token
        self.min_duration = min_duration
        self.multi_speaker = multi_speaker
        self.overflow = overflow
        self.split_ids = frozenset(split_ids)
        self.hop = voc.upsample_factor if voc is not None else None
        # (text bucket, batch bucket) -> its CapturedProgram, or None for
        # a grid point run eagerly
        self._programs: Dict[Tuple[int, int], Optional[CapturedProgram]] = {}
        self._pool = None
        # the weights rounded to the compute dtype, shared by every graph
        self._casts: dict = {}

    # ---- bucket arithmetic ------------------------------------------

    def max_frames(self, text_bucket: int) -> int:
        return text_bucket * self.frames_per_token

    def _text_bucket(self, n: int) -> int:
        i = bisect_left(self.text_buckets, n)
        return self.text_buckets[min(i, len(self.text_buckets) - 1)]

    def _batch_bucket(self, n: int) -> int:
        i = bisect_left(self.batch_buckets, n)
        return self.batch_buckets[i]  # chunks never exceed the largest

    @property
    def compiled_programs(self) -> int:
        """Distinct (text bucket, batch bucket) programs built so far
        (captured graphs, or grid points run eagerly)."""
        return len(self._programs)

    # ---- one padded chunk -------------------------------------------

    def _forward(self, text, text_lengths, spk_id, noise, max_frames):
        out = self.am.inference(text, text_lengths, max_frames=max_frames,
                                min_duration=self.min_duration,
                                spk_id=spk_id)
        mel, frames = out["after_outs"], out["frame_lengths"]
        # decoder output past each row's frame_lengths is arbitrary; clamp
        # the time index so padded frames repeat the row's last real
        # frame, as vocoding the trimmed mel with an edge pad would
        t = torch.minimum(
            torch.arange(mel.shape[1], device=mel.device)[None, :],
            torch.clamp(frames, min=1)[:, None] - 1)
        mel = torch.gather(mel, 1, t[..., None].expand(-1, -1, mel.shape[2]))
        if self.am_norm is not None:
            mel = self.am_norm.inverse(mel)
        if self.voc is None:
            return mel, frames
        if self.voc_norm is not None:
            mel = self.voc_norm.transform(mel)
        mel = edge_pad(mel, self.voc.aux_context_window)
        return self.voc(noise, mel)[..., 0], frames

    def _program(self, tb: int, bb: int) -> Optional[CapturedProgram]:
        key = (tb, bb)
        if key not in self._programs:
            self._programs[key] = (self._capture(tb, bb) if self.graphs
                                   else None)
        return self._programs[key]

    def _capture(self, tb: int, bb: int) -> CapturedProgram:
        """The graph of grid point (tb, bb), on every graph's shared pool;
        its inputs hold a batch of 1-token rows until a chunk fills
        them."""
        dev, long = self.device, torch.int64
        text = torch.zeros((bb, tb), dtype=long, device=dev)
        text[:, 0] = 1
        inputs = {"text": text,
                  "text_lengths": torch.ones(bb, dtype=long, device=dev)}
        if self.multi_speaker:
            inputs["spk_id"] = torch.zeros(bb, dtype=long, device=dev)
        if self.voc is not None:
            inputs["noise"] = torch.zeros(
                (bb, self.max_frames(tb) * self.hop, 1), device=dev)
        max_frames = self.max_frames(tb)

        def fn(text, text_lengths, spk_id=None, noise=None):
            audio, frames = self._forward(text, text_lengths, spk_id, noise,
                                          max_frames)
            return audio.float(), frames

        prog = CapturedProgram(fn, inputs, pool=self._pool,
                               casts=self._casts)
        self._pool = prog.pool()
        return prog

    def _noise_row(self, seed: int, tb: int) -> torch.Tensor:
        """Noise for one request, a function of its seed and text bucket
        ONLY: batching a request differently cannot change it."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        n = self.max_frames(tb) * self.hop
        return torch.randn((n, 1), generator=gen, device=self.device)

    def _run_chunk(self, chunk: List[Tuple[int, Request]], tb: int,
                   out: List[Optional[Result]]) -> None:
        bb = self._batch_bucket(len(chunk))
        text = np.zeros((bb, tb), np.int64)
        lengths = np.zeros(bb, np.int64)
        spk = np.zeros(bb, np.int64)
        for j, (_, req) in enumerate(chunk):
            ids = list(req.ids)[:tb]
            text[j, :len(ids)] = ids
            lengths[j] = len(ids)
            spk[j] = req.spk_id
        # pad rows get ONE real token: a zero-length row has fully masked
        # attention, which would put NaN into a row trimmed away anyway
        text[len(chunk):, 0] = 1
        lengths[len(chunk):] = 1
        noise = None
        if self.voc is not None:
            rows = [self._noise_row(req.seed, tb) for _, req in chunk]
            rows += [torch.zeros_like(rows[0])] * (bb - len(chunk))
            noise = torch.stack(rows)
        prog = self._program(tb, bb)
        if prog is None:
            def dev(a):
                return torch.from_numpy(a).to(self.device)

            with torch.inference_mode():
                audio, frames = self._forward(
                    dev(text), dev(lengths),
                    dev(spk) if self.multi_speaker else None, noise,
                    self.max_frames(tb))
                audio = audio.float().cpu().numpy()
                frames = frames.cpu().numpy()
        else:
            given = {"text": text, "text_lengths": lengths, "spk_id": spk}
            for name, buf in prog.inputs.items():
                buf.copy_(noise if name == "noise"
                          else torch.from_numpy(given[name]))
            audio, frames = prog()
            audio, frames = audio.cpu().numpy(), frames.cpu().numpy()
        for j, (i, req) in enumerate(chunk):
            n = int(frames[j])
            if self.voc is not None:
                out[i] = Result(req.utt_id, audio[j, :n * self.hop], None, n)
            else:
                out[i] = Result(req.utt_id, None, audio[j, :n], n)

    # ---- request assembly -------------------------------------------

    def _segments(self, req: Request, index: int) -> List[List[int]]:
        """Cut an over-bucket request into synthesizable segments per the
        overflow policy; in-bucket requests pass through whole."""
        cap = self.text_buckets[-1]
        ids = list(req.ids)
        if len(ids) <= cap:
            return [ids]
        if self.overflow == "error":
            raise ValueError(
                f"request {index} ({req.utt_id!r}): {len(ids)} phones "
                f"exceeds the largest text bucket ({cap}) and "
                f"overflow='error'")
        if self.overflow == "truncate":
            return [ids[:cap]]
        segs: List[List[int]] = []
        pos = 0
        while pos < len(ids):
            if len(ids) - pos <= cap:
                segs.append(ids[pos:])
                break
            cut = pos + cap
            # end the segment on the last pause token that fits
            for j in range(pos + cap - 1, pos, -1):
                if ids[j] in self.split_ids:
                    cut = j + 1
                    break
            segs.append(ids[pos:cut])
            pos = cut
        return segs

    def synthesize(self, requests: Sequence[Request]) -> List[Result]:
        """Batch-synthesize; results come back in request order.
        Over-bucket requests are split per ``overflow`` and their segment
        wavs (or mels) concatenated back into one Result."""
        subs: List[Request] = []
        owner: List[int] = []
        for i, req in enumerate(requests):
            if not len(req.ids):
                raise ValueError(f"request {i} ({req.utt_id!r}): empty "
                                 f"phone sequence")
            for k, seg in enumerate(self._segments(req, i)):
                # segment seed depends on the request seed and segment
                # index ONLY, preserving batch invariance
                subs.append(dataclasses.replace(
                    req, ids=seg,
                    seed=(req.seed + k * 0x9E3779B1) & 0xFFFFFFFF))
                owner.append(i)
        by_bucket = {}
        for j, req in enumerate(subs):
            by_bucket.setdefault(self._text_bucket(len(req.ids)),
                                 []).append((j, req))
        sub_out: List[Optional[Result]] = [None] * len(subs)
        cap = self.batch_buckets[-1]
        for tb, group in sorted(by_bucket.items()):
            for s in range(0, len(group), cap):
                self._run_chunk(group[s:s + cap], tb, sub_out)
        out: List[Optional[Result]] = [None] * len(requests)
        for i in range(len(requests)):
            parts = [sub_out[j] for j in range(len(subs)) if owner[j] == i]
            if len(parts) == 1:
                out[i] = parts[0]
                continue
            wavs = [p.wav for p in parts]
            mels = [p.mel for p in parts]
            out[i] = Result(
                parts[0].utt_id,
                None if wavs[0] is None else np.concatenate(wavs),
                None if mels[0] is None else np.concatenate(mels),
                sum(p.n_frames for p in parts))
        return out  # type: ignore[return-value]

    def warmup(self, batch_buckets: Optional[Sequence[int]] = None,
               text_buckets: Optional[Sequence[int]] = None) -> int:
        """Run every (text, batch) grid point once before serving traffic,
        so first-use costs (kernel build, library handles, allocator
        growth, the graphs' capture) do not land on a request; tail
        chunks route to smaller batch buckets, so the full grid is the
        default.  Returns how many programs exist afterwards."""
        for tb in (text_buckets or self.text_buckets):
            for bb in (batch_buckets or self.batch_buckets):
                self.synthesize([Request(ids=[1] * tb, seed=k)
                                 for k in range(bb)])
        return self.compiled_programs
