#!/usr/bin/env python3
"""A/B timing of the port's hand-written kernels on one card: this
checkout against variants of its CUDA sources, timed alternately.

    python3 scripts/kernel_ab.py [--parent DIR] [--flash_only] [TREE ...]

A TREE is one or more names of VARIANTS joined by "+".  Each is made as a
copy of tpu_ac_torch/ and chip_smoke.py under build/kernel_ab/<TREE>/ with
those source edits applied.  ``--parent DIR`` adds "parent", another
checkout of the repository (an earlier commit unpacked by git archive into
a directory that .gitignore lists).  Then "parent", "base" (this checkout)
and each tree run in turn, in that order and then reversed, each in a child
process that

  - builds that copy's kernels and prints ptxas's lines for them;
  - checks them against their plain versions at chip_smoke.py's stress
    shapes (min_dists, every mode and precision; not with --flash_only)
    and flash shapes;
  - times, with chip_smoke.py's timer, the min_dists kernel (symmetric bf16,
    N = 168, P = 784, D = 4096, the main path's larger category; not with
    --flash_only) and the flash kernel ([8, 12, 785, 64] in bf16 and in
    f32, the device's time and the wrapper's host time a call) beside
    scaled_dot_product_attention in the same type.

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
    # f32: 8 warps of 16 query rows (256 threads, at most 128 registers)
    "fa32_rows16": [
        (FA, "constexpr int F32_WARP_ROWS = 32;",
         "constexpr int F32_WARP_ROWS = 16;")],
    # f32: hi rounded to tf32 to nearest, ties away (cvt.rna's rounding:
    # one op more a split), so the split keeps 2^-21 |x| instead of 2^-20
    "fa32_hi_rna": [
        (FA, "  hi = __float_as_uint(x) & 0xffffe000u;",
         "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;")],
    # f32: lo = x - hi rounded to tf32 in the same way, not left for the
    # tensor cores to truncate (two ops more a split)
    "fa32_lo_rna": [
        (FA, "  lo = __float_as_uint(x - __uint_as_float(hi));",
         "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & "
         "0xffffe000u;")],
    # f32: each 3xTF32 pass over all of a step's accumulators before the
    # next pass, so that no mma waits on the one before it
    "fa32_passes": [
        (FA, """#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        // matrices: keys + 0 or + 8 (lane >> 4), the chunk of columns + 0
        // or + 4 (lane >> 3 & 1): b0, b1 of n-tile 2 np, then of 2 np + 1
        uint32_t kb[4];
        ldsm_x4(kb, kst + swz<float>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(kb[e]), bh[e >> 1][e & 1],
                     bl[e >> 1][e & 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_3xtf32(s[mt][2 * np], qh[mt], ql[mt], bh[0], bl[0]);
          mma_3xtf32(s[mt][2 * np + 1], qh[mt], ql[mt], bh[1], bl[1]);
        }
      }""", """      uint32_t bh[BN / 8][2], bl[BN / 8][2];
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, kst + swz<float>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(kb[e]), bh[2 * np + (e >> 1)][e & 1],
                     bl[2 * np + (e >> 1)][e & 1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          mma_tf32(s[mt][n], ql[mt], bh[n][0], bh[n][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          mma_tf32(s[mt][n], qh[mt], bl[n][0], bl[n][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          mma_tf32(s[mt][n], qh[mt], bh[n][0], bh[n][1]);"""),
        (FA, """#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        // column 8 dn + g is element g % 4 of chunk 2 dn + g / 4
        const int ch = 2 * dn + (g >> 2);
        uint32_t bh[2], bl[2];
        split_tf32(v0[((ch ^ (2 * t)) << 2) + (g & 3)], bh[0], bl[0]);
        split_tf32(v1[((ch ^ (2 * t + 1)) << 2) + (g & 3)], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(acc[mt][dn], ph[mt], pl[mt], bh, bl);
      }""", """      uint32_t bh[DH / 8][2], bl[DH / 8][2];
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        const int ch = 2 * dn + (g >> 2);
        split_tf32(v0[((ch ^ (2 * t)) << 2) + (g & 3)], bh[dn][0], bl[dn][0]);
        split_tf32(v1[((ch ^ (2 * t + 1)) << 2) + (g & 3)], bh[dn][1],
                   bl[dn][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int dn = 0; dn < DH / 8; ++dn)
          mma_tf32(acc[mt][dn], pl[mt], bh[dn][0], bh[dn][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int dn = 0; dn < DH / 8; ++dn)
          mma_tf32(acc[mt][dn], ph[mt], bl[dn][0], bl[dn][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int dn = 0; dn < DH / 8; ++dn)
          mma_tf32(acc[mt][dn], ph[mt], bh[dn][0], bh[dn][1]);""")],
    # f32: 96-row Q tiles (3 warps): 9 tiles of S = 785 instead of 7, the
    # last of 17 rows either way, so the blocks fill the waves better
    "fa32_bq96": [
        (FA, "constexpr int F32_BQ = 128;", "constexpr int F32_BQ = 96;")],
    # f32: the tf32 mma as plain (not volatile) asm, free to move
    "fa32_mma_asm": [
        (FA, """  asm volatile(
      "mma.sync.aligned.m16n8k8""", """  asm(
      "mma.sync.aligned.m16n8k8""")],
    # f32: K and V split once a tile in shared memory (hi in place, lo in
    # tiles of their own), not by every warp in registers; 160 KB a block
    "fa32_smem_split": [
        (FA, "constexpr int F32_SMEM = (F32_BQ + 2 * F32_STAGES * BN) * DH * 4;",
         "constexpr int F32_SMEM = (F32_BQ + 4 * F32_STAGES * BN) * DH * 4;\n"
         "constexpr int LO = 2 * F32_STAGES * BN * DH;"),
        (FA, """    cp_async_commit();
    // a warp whose rows all lie past S only helps with the copies
    if (q0 + wr >= S) continue;""",
         """    cp_async_commit();
    {
      float4* kc = reinterpret_cast<float4*>(ks + (kt % F32_STAGES) * BN * DH);
      float4* vc = reinterpret_cast<float4*>(vs + (kt % F32_STAGES) * BN * DH);
      for (int i = threadIdx.x; i < BN * DH / 4; i += THREADS) {
        float4* ps[2] = {kc + i, vc + i};
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          float4 x = *ps[w], hi, lo;
          uint32_t h, l;
          split_tf32(x.x, h, l); hi.x = __uint_as_float(h); lo.x = __uint_as_float(l);
          split_tf32(x.y, h, l); hi.y = __uint_as_float(h); lo.y = __uint_as_float(l);
          split_tf32(x.z, h, l); hi.z = __uint_as_float(h); lo.z = __uint_as_float(l);
          split_tf32(x.w, h, l); hi.w = __uint_as_float(h); lo.w = __uint_as_float(l);
          *ps[w] = hi;
          ps[w][LO / 4] = lo;
        }
      }
      __syncthreads();
    }
    if (q0 + wr >= S) continue;"""),
        (FA, """        uint32_t kb[4];
        ldsm_x4(kb, kst + swz<float>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(kb[e]), bh[e >> 1][e & 1],
                     bl[e >> 1][e & 1]);""",
         """        const int off = swz<float>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                   2 * kk + ((lane >> 3) & 1));
        uint32_t kh[4], kl[4];
        ldsm_x4(kh, kst + off);
        ldsm_x4(kl, kst + LO + off);
        const uint32_t bh[2][2] = {{kh[0], kh[1]}, {kh[2], kh[3]}};
        const uint32_t bl[2][2] = {{kl[0], kl[1]}, {kl[2], kl[3]}};"""),
        (FA, """        split_tf32(v0[((ch ^ (2 * t)) << 2) + (g & 3)], bh[0], bl[0]);
        split_tf32(v1[((ch ^ (2 * t + 1)) << 2) + (g & 3)], bh[1], bl[1]);""",
         """        const int o0 = ((ch ^ (2 * t)) << 2) + (g & 3);
        const int o1 = ((ch ^ (2 * t + 1)) << 2) + (g & 3);
        bh[0] = __float_as_uint(v0[o0]);
        bl[0] = __float_as_uint(v0[o0 + LO]);
        bh[1] = __float_as_uint(v1[o1]);
        bl[1] = __float_as_uint(v1[o1 + LO]);""")],
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


def run_one(tree: str, path: str, flash_only: bool) -> None:
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
    if not flash_only:
        cs.phase_stress(torch, dist)
    cs.phase_flash_kernel(torch, attn)

    row = {"tree": tree}
    gen = torch.Generator(device="cuda").manual_seed(1)
    if not flash_only:
        Z = torch.randn(168, 784, 4096, device="cuda", generator=gen) * 0.5
        row["min_dists_symmetric_ms"], row["min_dists_host_ms"] = \
            cs._time_ms(lambda: dist.min_dists_all_pairs(
                Z, Z, precision="bf16", symmetric=True), reps=3)
        del Z
    scale = cs.FLASH_SHAPE[-1] ** -0.5
    for tag, dtype in (("flash", torch.bfloat16), ("flash_f32",
                                                   torch.float32)):
        q, k, v = cs._packed_qkv(torch, gen, *cs.FLASH_SHAPE, dtype)
        row[f"{tag}_ms"], row[f"{tag}_host_ms"] = cs._time_ms(
            lambda: attn.flash_attention_impl(q, k, v, scale), reps=20,
            warmup=3)
        row[f"{tag}_sdpa_ms"], _ = cs._time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale), reps=20, warmup=3)
    print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="variants joined by '+'")
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout, run as the tree 'parent'")
    ap.add_argument("--flash_only", action="store_true",
                    help="check and time the flash kernel only")
    ap.add_argument("--run", nargs=2, metavar=("TREE", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(*args.run, args.flash_only)
        return
    for tree in args.trees:
        unknown = set(tree.split("+")) - set(VARIANTS)
        if unknown:
            ap.error(f"unknown variants {sorted(unknown)}; know "
                     f"{sorted(VARIANTS)}")
    paths = {"base": ROOT, **{t: make_tree(t) for t in args.trees}}
    one = ["base", *args.trees]
    if args.parent:
        paths["parent"] = os.path.abspath(args.parent)
        one.insert(0, "parent")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    failed = []
    for tree in one + one[::-1]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--run", tree, paths[tree]]
                            + ["--flash_only"] * args.flash_only, timeout=900
                            ).returncode
        if rc:  # a variant that fails its checks or its launch
            print(json.dumps({"tree": tree, "failed": rc}), flush=True)
            failed.append(tree)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
