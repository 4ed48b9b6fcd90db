"""What the cluster exchange costs the wide K4b and K4c (head widths above
256), by cutting it out of copies of the kernels.

The wide backward passes run as thread-block clusters: at every tile each
block forms the partial S and dP over its own columns, stores them to a
slot, waits at a cluster barrier, and adds every block's slot through
distributed shared memory (``sum_ranks`` in csrc/flash_attn.cuh).  This
script copies the package into ``build/k4_exchange/<variant>/`` four
times, edits three copies' source, builds all four (one process each, in
parallel), and times K4b and K4c of each, one process at a time, at
``chip_smoke.py``'s K4 shapes above 256 (B=16, T=1024 with 700-1,024
valid keys, H=1, dk 384 and 512, float32 and bf16):

- ``full``: the kernels as they are;
- ``own_only``: each block adds only its own slot (the barrier kept, the
  loads from the other blocks cut);
- ``barrier_only``: no slot is read (the barrier kept; the block's own
  partial stands for the sum);
- ``no_exchange``: neither the barrier in the loop nor the loads.

The edited copies compute wrong gradients: they are timed, never held to
anything.  ``full`` runs first and last, so that the spread of one
variant's time shows.  It prints the card's name and power limit as
``nvidia-smi`` gives them, then one JSON line a variant, shape and type
(median ms of 20 calls each, CUDA events).

Usage (on the card, from the root of the repository):

    python3 tools/k4_wide_exchange_cost.py
"""
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k4_exchange"
CUH, CU = "flash_attn.cuh", "flash_attn_wide_bwd.cu"
LOOP = "  for (int r = 0; r < nrank; ++r) {"
SYNC = ("    store_part(slot_part<NT>(slot(s), wg, rw), sacc);\n"
        "    cluster_sync();")
# variant: (source, text, replacement) edits
VARIANTS = {
    "full": [],
    "own_only": [(CUH, LOOP,
                  "  for (int r = blockIdx.x; r < blockIdx.x + 1; ++r) {")],
    "barrier_only": [(CUH, LOOP, "  for (int r = 0; r < 0; ++r) {")],
    "no_exchange": [(CUH, LOOP, "  for (int r = 0; r < 0; ++r) {"),
                    (CU, SYNC, SYNC.split("\n")[0])],
}
ORDER = ("full", "own_only", "barrier_only", "no_exchange", "full")


def make(name):
    """The package copied to OUT/name with the variant's edits."""
    dst = OUT / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "parakeet_tpu_torch", dst / "parakeet_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, text, repl in VARIANTS[name]:
        path = dst / "parakeet_tpu_torch" / "csrc" / source
        src = path.read_text()
        if text not in src:
            raise RuntimeError(f"{name}: {source} no longer holds the text "
                               "this variant edits")
        path.write_text(src.replace(text, repl))
    return dst


def time_variant(name):
    """One JSON line a shape and type: K4b's and K4c's median ms."""
    import torch
    sys.path.insert(0, str(OUT / name))
    from parakeet_tpu_torch.ops.kernels import flash_attn as k4
    assert str(OUT / name) in k4.__file__

    def ms(fn, reps=20):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    gen = torch.Generator().manual_seed(7)
    b, h, t = 16, 1, 1024
    lengths = torch.randint(700, t + 1, (b,), generator=gen)
    kv = (torch.arange(t)[None] < lengths[:, None]).to(torch.int32).cuda()
    qv = torch.ones_like(kv)
    for d in (384, 512):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn((b, h, t, d), generator=gen).cuda()
                           .to(dtype) for _ in range(4))
            scale = d ** -0.5
            o, lse = k4.flash_attention_forward(q, k, v, qv, kv,
                                                sm_scale=scale)
            di = (o.float() * do.float()).sum(-1)
            args = (q, k, v, qv, kv, do, lse, di)
            print(json.dumps({
                "variant": name, "dk": d, "dtype": str(dtype).split(".")[1],
                "k4b_ms": ms(lambda: k4.flash_attention_dkv(
                    *args, sm_scale=scale)),
                "k4c_ms": ms(lambda: k4.flash_attention_dq(
                    *args, sm_scale=scale))}), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_variant(sys.argv[2])
        return
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("k4_wide_exchange_cost.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from "
             "parakeet_tpu_torch.ops.kernels._build import load_library; "
             "load_library()")
    procs = [subprocess.Popen([sys.executable, "-c", build, str(make(n))])
             for n in VARIANTS]
    if any(p.wait() for p in procs):
        raise RuntimeError("a variant's build failed")
    for name in ORDER:
        subprocess.run([sys.executable, __file__, "--time", name],
                       check=True)


if __name__ == "__main__":
    main()
