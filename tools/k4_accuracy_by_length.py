"""K4's error by sequence length, against a float64 softmax attention.

For each length (batch 1, FastSpeech2's 4 heads of 96, the synthesis
graphs' lengths and the training step's) and each type, prints one JSON
line: the max abs error of K4a's o, K4b's dk/dv and K4c's dq against the
same function in float64, beside the error of their plain float32
versions (``flash_attention_reference`` and the two backward references,
blocked at ``k4a_block_k`` for o as well) against it, the kernels'
error against the plain versions, each output's range and the range of
v.  It shows whether the kernels' distance from their plain versions
grows with the length as float32 rounding does, or faster.

The card's name and power limit come first, as ``nvidia-smi`` gives them.

Usage (on the card): python3 tools/k4_accuracy_by_length.py
"""
import json
import math
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from parakeet_tpu_torch.ops.kernels import flash_attn as k4  # noqa: E402

H, DK = 4, 96
# (T, valid keys): e2e_rtf's encoder and decoder, longform_rtf's encoder,
# the training step's decoder, then longer
LENGTHS = ((128, 128), (896, 357), (512, 512), (1024, 1024), (2048, 2048),
           (4096, 4096), (6144, 6144))


def truth(q, k, v, kv_valid, do, scale):
    """o, dq, dk, dv of softmax(q k^T scale) v in float64, keys masked."""
    q, k, v, do = (x.double().requires_grad_() if i < 3 else x.double()
                   for i, x in enumerate((q, k, v, do)))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = s.masked_fill(kv_valid[:, None, None, :] == 0, -math.inf)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    return o.detach(), dq, dk, dv


def err(a, b):
    return (a.double() - b.double()).abs().max().item()


def span(a):
    return a.double().abs().max().item()


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    scale = 1.0 / math.sqrt(DK)
    for t, n_valid in LENGTHS:
        kv_valid = (torch.arange(t)[None] < n_valid).to(torch.int32).cuda()
        q_valid = torch.ones_like(kv_valid)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn((1, H, t, DK), generator=gen).cuda()
                           .to(dtype) for _ in range(4))
            args = (q, k, v, q_valid, kv_valid)
            o, lse = k4.flash_attention_forward(*args, sm_scale=scale)
            ref_o, _ = k4.flash_attention_reference(*args, sm_scale=scale)
            blk_o, _ = k4.flash_attention_reference(
                *args, sm_scale=scale, block_k=k4.k4a_block_k(dtype, DK))
            di = (o.float() * do.float()).sum(-1)
            bwd = args + (do, lse, di)
            dq = k4.flash_attention_dq(*bwd, sm_scale=scale)
            dk, dv = k4.flash_attention_dkv(*bwd, sm_scale=scale)
            ref_dq = k4.flash_attention_dq_reference(*bwd, sm_scale=scale)
            ref_dk, ref_dv = k4.flash_attention_dkv_reference(
                *bwd, sm_scale=scale)
            t_o, t_dq, t_dk, t_dv = truth(q, k, v, kv_valid, do, scale)
            rec = {"T": t, "valid": n_valid, "dtype": str(dtype)[6:],
                   "v_range": span(v)}
            for name, got, ref, exact, extra in (
                    ("o", o, ref_o, t_o, {"blocked_vs_truth": err(blk_o,
                                                                  t_o),
                                          "kernel_vs_blocked": err(o,
                                                                   blk_o)}),
                    ("dq", dq, ref_dq, t_dq, {}), ("dk", dk, ref_dk, t_dk, {}),
                    ("dv", dv, ref_dv, t_dv, {})):
                rec[name] = {"range": span(ref),
                             "kernel_vs_plain": err(got, ref),
                             "kernel_vs_truth": err(got, exact),
                             "plain_vs_truth": err(ref, exact), **extra}
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
