#!/usr/bin/env python3
"""A/B timing of the port's hand-written kernels on one card: this
checkout against variants of its CUDA sources, timed alternately.

    python3 scripts/kernel_ab.py TREE [TREE ...]

A TREE is one or more names of VARIANTS joined by "+".  Each is made as a
copy of tpu_ac_torch/ and chip_smoke.py under build/kernel_ab/<TREE>/ with
those source edits applied.  Then "base" (this checkout) and each tree run
in turn, in the order base, trees, trees reversed, base, each in a child
process that

  - builds that copy's kernels and prints ptxas's lines for them;
  - checks them against their plain versions at chip_smoke.py's stress
    shapes (min_dists, every mode and precision) and flash shapes;
  - times, with chip_smoke.py's timer, the min_dists kernel (symmetric bf16,
    N = 168, P = 784, D = 4096, the main path's larger category) and the
    flash kernel (bf16 [8, 12, 785, 64]) beside
    scaled_dot_product_attention.

Each run prints one JSON line; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MD = "tpu_ac_torch/csrc/min_dists.cu"
FA = "tpu_ac_torch/csrc/flash_attention.cu"

# name -> [(file, text, replacement)]; each text occurs once in its file
VARIANTS = {
    # the warpgroup's role read through a warp shuffle, which ptxas can
    # prove uniform: the wgmmas are no longer serialized (warning C7520)
    "md_role_shfl": [
        (MD, "const int wg = tid / 128;",
         "const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);")],
    # one wgmma group left in flight: a stage is released after the next
    # stage's wgmmas are issued and its own have completed
    "md_wait1": [
        (MD, """          wgmma_commit_wait();
        }
        if (lane == 0) mbar_arrive(&empty[stage]);""",
         """          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        }
        if (st > 0 && lane == 0)
          mbar_arrive(&empty[(stage + STAGES - 1) % STAGES]);"""),
        (MD, """      fence_acc(acc0);
      fence_acc(acc1);""",
         """      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (lane == 0) mbar_arrive(&empty[(stage + STAGES - 1) % STAGES]);
      fence_acc(acc0);
      fence_acc(acc1);""")],
    # 8 warps of 16 query rows (256 threads, 2 blocks an SM)
    "fa_rows16": [
        (FA, "constexpr int WARP_ROWS = 32;", "constexpr int WARP_ROWS = 16;"),
        (FA, "__launch_bounds__(BF16_THREADS, SEG ? 2 : 3)",
         "__launch_bounds__(BF16_THREADS, 2)")],
    # the library's exp2f in place of the one-instruction ex2
    "fa_exp2f": [
        (FA, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
         "y = exp2f(x);")],
}


def make_tree(tree: str) -> str:
    """build/kernel_ab/<tree>/: a copy of the port with the edits of each
    variant in ``tree`` applied."""
    dest = os.path.join(ROOT, "build", "kernel_ab", tree)
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    shutil.copytree(os.path.join(ROOT, "tpu_ac_torch"),
                    os.path.join(dest, "tpu_ac_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dest)
    for name in tree.split("+"):
        for rel, old, new in VARIANTS[name]:
            path = os.path.join(dest, rel)
            with open(path) as f:
                src = f.read()
            if src.count(old) != 1:
                sys.exit(f"kernel_ab: variant {name}: its text occurs "
                         f"{src.count(old)} times in {rel}")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
    return dest


def run_one(tree: str, path: str) -> None:
    """The child: build, check and time the kernels of the copy at
    ``path``."""
    sys.path.insert(0, path)
    import torch

    import chip_smoke as cs
    from tpu_ac_torch.kernels import attention as attn
    from tpu_ac_torch.kernels import build
    from tpu_ac_torch.kernels import distances as dist

    if not dist.__file__.startswith(path):
        sys.exit(f"kernel_ab: imported {dist.__file__}, not the copy at "
                 f"{path}")
    build.build_all()
    for name, log in build.BUILD_LOG.items():
        cs._print_ptxas(f"{tree} {name}", log)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_stress(torch, dist)
    cs.phase_flash_kernel(torch, attn)

    gen = torch.Generator(device="cuda").manual_seed(1)
    Z = torch.randn(168, 784, 4096, device="cuda", generator=gen) * 0.5
    md_ms, md_host_ms = cs._time_ms(lambda: dist.min_dists_all_pairs(
        Z, Z, precision="bf16", symmetric=True), reps=3)
    del Z
    q, k, v = cs._packed_qkv(torch, gen, *cs.FLASH_SHAPE, torch.bfloat16)
    scale = cs.FLASH_SHAPE[-1] ** -0.5
    fa_ms, fa_host_ms = cs._time_ms(
        lambda: attn.flash_attention_impl(q, k, v, scale), reps=20, warmup=3)
    sdpa_ms, _ = cs._time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale), reps=20, warmup=3)
    print(json.dumps({"tree": tree, "min_dists_symmetric_ms": md_ms,
                      "min_dists_host_ms": md_host_ms, "flash_ms": fa_ms,
                      "flash_host_ms": fa_host_ms, "sdpa_ms": sdpa_ms}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="variants joined by '+'")
    ap.add_argument("--run", nargs=2, metavar=("TREE", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(*args.run)
        return
    for tree in args.trees:
        unknown = set(tree.split("+")) - set(VARIANTS)
        if unknown:
            ap.error(f"unknown variants {sorted(unknown)}; know "
                     f"{sorted(VARIANTS)}")
    paths = {"base": ROOT, **{t: make_tree(t) for t in args.trees}}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    one = ["base", *args.trees]
    failed = []
    for tree in one + one[::-1]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--run", tree, paths[tree]], timeout=900
                            ).returncode
        if rc:  # a variant that fails its checks or its launch
            print(json.dumps({"tree": tree, "failed": rc}), flush=True)
            failed.append(tree)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
