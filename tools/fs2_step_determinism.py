"""Which gradients of the FastSpeech2 recipe's step change from run to run.

Builds the model of recipes/fastspeech2/conf/default.yaml at its full
widths (adim 384 over 2 heads, 'flash', attention dropout 0) on the card,
draws one batch of 64 utterances of 500-1000 frames from a seeded
synthetic dump under build/, and runs the same forward and backward
(dropout on, the same generator seed) twice from copies of the model,
the first right after ``torch.cuda.empty_cache()`` (the caching allocator
holds no free block, as at the start of a process) and the second with
the blocks the first left cached: with PyTorch's default algorithms,
with cuDNN's deterministic convolutions only, under
``torch.use_deterministic_algorithms`` (also with the first step on a
warm allocator), and under it with cuDNN off (as the recipe's CLI
trains).  For each it prints how many parameters'
gradients differ between the two runs and the first of their names.  The
card's name and power limit come first, as ``nvidia-smi`` gives them.

Usage (on the card, from the repository's root):
    python3 tools/fs2_step_determinism.py
"""
import copy
import pathlib
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from parakeet_tpu_torch.models import fastspeech2_loss  # noqa: E402
from parakeet_tpu_torch.recipes.fastspeech2 import train  # noqa: E402
from parakeet_tpu_torch.recipes.fastspeech2.dump import \
    write_synthetic_dump  # noqa: E402
from parakeet_tpu_torch.training import Config, to_device_batch  # noqa: E402

CONF = "recipes/fastspeech2/conf/default.yaml"
OPTS = ["model.attn_impl", "flash",
        "model.transformer_enc_attn_dropout_rate", "0.0",
        "model.transformer_dec_attn_dropout_rate", "0.0"]
KEYS = ("text", "text_lengths", "speech", "speech_lengths", "durations",
        "pitch", "energy")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("fs2_step_determinism.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = pathlib.Path("build") / "fs2_step_determinism"
    shutil.rmtree(out, ignore_errors=True)
    md = write_synthetic_dump(out, seed=1, splits={"train": 64},
                              frames=(500, 1000), phones=(40, 120))
    cfg = Config.from_yaml(CONF).merge_opts(OPTS)
    loader = train.build_dataloader(md["train"], cfg, True, False)
    batch = to_device_batch(next(iter(loader)), "cuda")
    idim = len(md["phones"].read_text().splitlines())
    model = train.build_model(cfg, idim, batch["speech"].shape[-1]).cuda()

    def grads():
        m = copy.deepcopy(model)
        out = m(*[batch[k] for k in KEYS], deterministic=False,
                rng=torch.Generator(device="cuda").manual_seed(3))
        fastspeech2_loss(out, batch)["loss"].backward()
        return {n: p.grad for n, p in m.named_parameters()}

    def compare(what, cold=True):
        if cold:
            torch.cuda.empty_cache()
        a = grads()
        b = grads()
        differ = [n for n in a if not torch.equal(a[n], b[n])]
        print(f"{what}: {len(differ)} of {len(a)} gradients differ between "
              f"two identical steps: {differ[:6]}", flush=True)

    compare("default algorithms")
    torch.backends.cudnn.deterministic = True
    compare("cudnn.deterministic")
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    compare("torch.use_deterministic_algorithms")
    compare("torch.use_deterministic_algorithms, the first step on a warm "
            "allocator", cold=False)
    torch.backends.cudnn.enabled = False
    compare("torch.use_deterministic_algorithms, cuDNN off")
    shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main()
