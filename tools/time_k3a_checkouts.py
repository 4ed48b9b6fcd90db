"""Time kernel K3a (the PWG discriminator's forward) of this checkout
against the K3a of other checkouts, on one CUDA card, in turns.

    python3 tools/time_k3a_checkouts.py DIR [DIR ...]

Each DIR holds a ``parakeet_tpu_torch`` package (another commit unpacked
with ``git archive``, or a copy with an edited ``csrc/pwg_disc.cu``); it is
imported under a name of its own and builds its kernels under DIR/build.
For each checkout the script prints the ptxas registers and spill bytes of
its ``disc_`` kernels, checks that its logits and saved streams equal this
checkout's bit for bit at three shapes, then times ``fused_disc_forward``
with and without saving at B=8, T=25,500 (the PWGAN recipe's batch):
single calls, and 10 calls back to back (the card's time, without a
short call's host overhead), median ms a call, in the order this, DIR...,
DIR... reversed, this.
"""
import argparse
import importlib
import importlib.util
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from parakeet_tpu_torch.ops.kernels import pwg_disc  # noqa: E402
from parakeet_tpu_torch.ops.kernels._build import load_library  # noqa: E402


def load_checkout(root, name):
    """DIR's pwg_disc and _build modules, its package imported as name."""
    pkg = pathlib.Path(root).resolve() / "parakeet_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.kernels.pwg_disc"),
            importlib.import_module(f"{name}.ops.kernels._build"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("dirs", nargs="+", metavar="DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    mods = {"this": (pwg_disc, load_library)}
    for i, d in enumerate(args.dirs):
        disc, build = load_checkout(d, f"checkout{i}")
        mods[d] = (disc, build.load_library)
    for name, (_, lib) in mods.items():
        print(f"{name} ptxas: " + ", ".join(
            f"{k} {regs} ({st + ld})"
            for k, regs, st, ld in chip_smoke.ptxas_entries(lib().log)
            if k.startswith("disc_")))
    gen = torch.Generator().manual_seed(4)
    kernels = [torch.randn((3, 64, 1 if j == 8 else 64), generator=gen) / 14
               for j in range(9)]
    biases = [0.05 * torch.randn(k.shape[-1], generator=gen)
              for k in kernels]
    wk, bk = (a.cuda() for a in pwg_disc.pack_disc_weights(kernels, biases))
    for b, t in ((3, 1001), (1, 37), (8, 25_500)):
        h = torch.randn((b, t, 64), generator=gen).cuda()
        want = pwg_disc.fused_disc_forward(h, wk, bk, slope=0.2, save=True)
        for name, (disc, _) in mods.items():
            got = disc.fused_disc_forward(h, wk, bk, slope=0.2, save=True)
            got_n = disc.fused_disc_forward(h, wk, bk, slope=0.2,
                                            save=False)
            same = (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])
                    and torch.equal(got_n[0], want[0]))
            print(f"{name} B={b} T={t}: "
                  + ("bitwise this checkout's" if same else "DIFFERS"))
    # h is the last shape's: B=8, T=25,500
    order = list(mods) + list(mods)[::-1]
    for save in (True, False):
        for label, timer in (("single calls", chip_smoke.cuda_ms),
                             ("10 back to back, a call",
                              chip_smoke.cuda_ms_per_call)):
            times = {name: [] for name in mods}
            for name in order:
                disc = mods[name][0]
                times[name].append(timer(
                    lambda d=disc: d.fused_disc_forward(
                        h, wk, bk, slope=0.2, save=save), 10))
            print(f"K3a {'with' if save else 'without'} saving, B=8 "
                  f"T=25500, {label}, median ms in the order "
                  f"{' '.join(order)}: " + "; ".join(
                      f"{name} " + ", ".join(f"{x:.4f}" for x in ts)
                      for name, ts in times.items()))


if __name__ == "__main__":
    main()
