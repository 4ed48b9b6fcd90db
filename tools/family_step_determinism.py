"""Which gradients of the SpeedySpeech and Tacotron2 recipes' steps change
from run to run, and what each setting costs a step.

Builds each recipe's model at its YAML's full widths on the card
(recipes/speedyspeech/conf/default.yaml, recipes/tacotron2/conf/
default.yaml), draws one batch of 32 utterances from a seeded synthetic
dump under build/ (SpeedySpeech 300-600 frames, Tacotron2 120-200, as
``chip_smoke.py``'s recipe phases), and runs the same forward and
backward (dropout on, the same generator seed) twice from copies of the
model, the first right after ``torch.cuda.empty_cache()`` (the caching
allocator holds no free block, as at the start of a process) and the
second with the blocks the first left cached: with PyTorch's default
algorithms, under ``torch.use_deterministic_algorithms`` with cuDNN on
(also with the first step on a warm allocator), and under it with cuDNN
off (``training/seeding.py::deterministic_training``, the recipes'
setting).  For each it prints how many parameters' gradients differ
between the two runs, the first of their names, and the median wall ms
of a forward and backward over 3 more (synchronised).  With
``--profile DIR`` it also writes, for each family, the ``torch.profiler``
table by op of one such step in the recipes' setting.  The card's name
and power limit come first, as ``nvidia-smi`` gives them.

Usage (on the card, from the repository's root):
    python3 tools/family_step_determinism.py [--profile DIR]
"""
import argparse
import copy
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from parakeet_tpu_torch.models import (speedyspeech_loss,  # noqa: E402
                                       tacotron2_loss)
from parakeet_tpu_torch.recipes.speedyspeech import train as ss  # noqa: E402
from parakeet_tpu_torch.recipes.speedyspeech.dump import \
    write_synthetic_dump as ss_dump  # noqa: E402
from parakeet_tpu_torch.recipes.tacotron2 import train as t2  # noqa: E402
from parakeet_tpu_torch.recipes.tacotron2.dump import \
    write_synthetic_dump as t2_dump  # noqa: E402
from parakeet_tpu_torch.training import (Config,  # noqa: E402
                                         deterministic_training,
                                         to_device_batch)

OUT = pathlib.Path("build") / "family_step_determinism"


def speedyspeech_step(out):
    md = ss_dump(out, seed=1, splits={"train": 32}, frames=(300, 600),
                 phones=(40, 90))
    cfg = Config.from_yaml("recipes/speedyspeech/conf/default.yaml")
    batch = to_device_batch(next(iter(ss.build_dataloader(
        md["train"], cfg, True))), "cuda")
    model = ss.build_model(cfg, ss.count_lines(md["phones"]),
                           ss.count_lines(md["tones"])).cuda()

    def loss(m, rng):
        outputs = m(batch["phones"], batch["durations"],
                    tones=batch["tones"],
                    max_frames=batch["feats"].shape[1], deterministic=False)
        return speedyspeech_loss(outputs, batch)["loss"]
    return model, loss


def tacotron2_step(out):
    md = t2_dump(out, seed=1, splits={"train": 32}, frames=(120, 200),
                 phones=(30, 60))
    cfg = Config.from_yaml("recipes/tacotron2/conf/default.yaml")
    batch = to_device_batch(next(iter(t2.build_dataloader(
        md["train"], cfg, True))), "cuda")
    model = t2.build_model(cfg, ss.count_lines(md["phones"])).cuda()

    def loss(m, rng):
        outputs = m(batch["text"], batch["text_lengths"], batch["speech"],
                    batch["speech_lengths"], deterministic=False, rng=rng)
        return tacotron2_loss(outputs, batch["speech"],
                              batch["speech_lengths"],
                              batch["text_lengths"])["loss"]
    return model, loss


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", default=None, metavar="DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("family_step_determinism.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(OUT, ignore_errors=True)
    for name, build in (("speedyspeech", speedyspeech_step),
                        ("tacotron2", tacotron2_step)):
        model, loss = build(OUT / name)

        def grads():
            m = copy.deepcopy(model)
            loss(m, torch.Generator(device="cuda").manual_seed(3)).backward()
            return {n: p.grad for n, p in m.named_parameters()}

        def step_ms():
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grads()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            return statistics.median(times)

        def compare(what, cold=True):
            if cold:
                torch.cuda.empty_cache()
            a = grads()
            b = grads()
            differ = [n for n in a if not torch.equal(a[n], b[n])]
            print(f"{name}, {what}: {len(differ)} of {len(a)} gradients "
                  f"differ between two identical steps: {differ[:4]}; "
                  f"forward and backward {step_ms():.1f} ms (median of 3)",
                  flush=True)

        compare("default algorithms")
        torch.use_deterministic_algorithms(True, warn_only=True)
        compare("torch.use_deterministic_algorithms")
        compare("torch.use_deterministic_algorithms, the first step on a "
                "warm allocator", cold=False)
        torch.use_deterministic_algorithms(False)
        with deterministic_training():
            compare("deterministic_training (cuDNN off)")
            if args.profile:
                prof_dir = pathlib.Path(args.profile)
                prof_dir.mkdir(parents=True, exist_ok=True)
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    grads()
                    torch.cuda.synchronize()
                (prof_dir / f"{name}_step_deterministic.txt").write_text(
                    prof.key_averages().table(sort_by="cuda_time_total",
                                              row_limit=25))
    shutil.rmtree(OUT, ignore_errors=True)


if __name__ == "__main__":
    main()
