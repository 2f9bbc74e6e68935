"""Where K17-K19 (``csrc/flash_attention.cu``) spend their time, on the
card: ``python -m sparse_matrix_fine_tuning_torch.scripts.probe_attention [--variants NAME ...]``.

Builds patched copies of ``flash_attention.cu`` (``VARIANTS``), each into a
library of its own (nvcc, in parallel), with one phase dropped or one
choice changed, and times K17, K18 and K19 in bf16 in turns with the
unpatched kernels at ``compare_attention.SHAPES``.  A dropped phase leaves the results
wrong: those variants are timed, never checked (the unpatched kernels and
the whole ones, ``CHECKED``, are checked against the plain versions first).
The difference of a variant's time to the whole kernel's is what that phase
costs where it does not overlap the rest; a variant that patches one
kernel leaves the other's time as a measure of the noise.
``tests/test_torch_probe_attention.py`` checks on the CPU that every patch
still applies to this tree's source.  It needs a CUDA card and fails
without one.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import torch

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.scripts import compare_attention as cmp
from sparse_matrix_fine_tuning_torch.utils import benchlib

SOURCE = cmp.SOURCE
OUT = kbuild.BUILD_ROOT / "probe_attention"
KERNELS = ("splash_fwd", "splash_dq", "splash_dkv")
_NEVER = "a.T < 0"  # a condition the compiler cannot fold: the work never runs
# name -> [(text of this tree's flash_attention.cu, its replacement)]
VARIANTS = {
    "full": [],
    # K17: the exponentials of the online softmax (s - m kept as it is)
    "fwd no exp": [("s[4 * jj + 2 * rr] = ex2(fmaf(s[4 * jj + 2 * rr], kLog2e, -ml));",
                    "s[4 * jj + 2 * rr] = fmaf(s[4 * jj + 2 * rr], kLog2e, -ml);"),
                   ("s[4 * jj + 2 * rr + 1] = ex2(fmaf(s[4 * jj + 2 * rr + 1], kLog2e, -ml));",
                    "s[4 * jj + 2 * rr + 1] = fmaf(s[4 * jj + 2 * rr + 1], kLog2e, -ml);")],
    # K17: the two warpgroups' turns dropped (both issue as they come; checked)
    "fwd no turns": [('  asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");', ""),
                     ('  asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");', "")],
    # K17: kv tiles of the other height at head_dim 64 (128 rows <-> 64; checked)
    "fwd kv rows": [("constexpr int fwd_kv_rows(int D) { return D == 64 ? 128 : 64; }",
                     "constexpr int fwd_kv_rows(int D) { return D == 64 ? 64 : 64; }")],
    # K17: the P.V wgmmas
    "fwd no P.V": [("for (int kk = 0; kk < kSteps; ++kk) mma_rs<D>(o, p[kk], mnmajor(vs, kBc, kk));",
                    f"for (int kk = 0; {_NEVER} && kk < kSteps; ++kk) "
                    "mma_rs<D>(o, p[kk], mnmajor(vs, kBc, kk));")],
    # K17: the S = q k^T wgmmas
    "fwd no S": [("      for (int kk = 0; kk < D / 16; ++kk)\n        mma_ss<kBc>(",
                  f"      for (int kk = 0; {_NEVER} && kk < D / 16; ++kk)\n        mma_ss<kBc>(")],
    # K17: two stages of k and v (checked)
    "fwd 2 stages": [("static constexpr int kStages = 3;",
                      "static constexpr int kStages = 2;")],
    # K19: the producer's loads of lse and di (zeros stored)
    "dkv no lse/di loads": [("lv[c] = row < a.T ? lse[row] : 0.f;", "lv[c] = 0.f;"),
                            ("dv[c] = row < a.T ? di[row] : 0.f;", "dv[c] = 0.f;")],
    # K19: the exponentials of P^T
    "dkv no exp": [("const float pv = __expf(keep ? s[4 * jj + e] - sl[c] : -INFINITY);",
                    "const float pv = keep ? s[4 * jj + e] - sl[c] : 0.f;")],
    # K19: the S^T and dP^T wgmmas
    "dkv no S dP": [("for (int kk = 0; kk < D / 16; ++kk) {\n          mma_ss<BQ>(s,",
                     f"for (int kk = 0; {_NEVER} && kk < D / 16; ++kk) {{\n          mma_ss<BQ>(s,")],
    # K19: the dV and dK wgmmas
    "dkv no dV dK": [("for (int kk = 0; kk < BQ / 16; ++kk) {\n          if constexpr (P::kDv)",
                      f"for (int kk = 0; {_NEVER} && kk < BQ / 16; ++kk) {{\n"
                      "          if constexpr (P::kDv)")],
    # K19 with K17's turns (named barriers 5 + wg): one around the issue of
    # S^T and dP^T, one around dV and dK's, dummy turns at skipped steps
    # (checked)
    "dkv turns": [
        ('__device__ __forceinline__ void turn_pass(int wg) {\n'
         '  asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");\n}\n',
         '__device__ __forceinline__ void turn_pass(int wg) {\n'
         '  asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");\n}\n'
         '__device__ __forceinline__ void dkv_turn_wait(int wg) {\n'
         '  asm volatile("bar.sync %0, 256;" ::"r"(5 + wg) : "memory");\n}\n'
         '__device__ __forceinline__ void dkv_turn_pass(int wg) {\n'
         '  asm volatile("bar.arrive %0, 256;" ::"r"(6 - wg) : "memory");\n}\n'),
        ("const uint32_t dv_stage = dk_stage + C::kKvBytes;",
         "const uint32_t dv_stage = dk_stage + C::kKvBytes;\n  if (wg == 1) dkv_turn_pass(wg);"),
        ("if (t == 0) mbar_arrive(empty + 8 * st);\n          continue;",
         "if (t == 0) mbar_arrive(empty + 8 * st);\n"
         "          for (int u = 0; u < 2; ++u) { dkv_turn_wait(wg); dkv_turn_pass(wg); }\n"
         "          continue;"),
        ("        wgmma_fence();\n#pragma unroll\n        for (int kk = 0; kk < D / 16; ++kk) {",
         "        dkv_turn_wait(wg);\n        wgmma_fence();\n#pragma unroll\n"
         "        for (int kk = 0; kk < D / 16; ++kk) {"),
        ("        wgmma_commit();\n        wgmma_wait<0>();\n        fence_acc(s);",
         "        wgmma_commit();\n        dkv_turn_pass(wg);\n        wgmma_wait<0>();\n"
         "        fence_acc(s);"),
        ("        wgmma_fence();\n#pragma unroll\n        for (int kk = 0; kk < BQ / 16; ++kk) {",
         "        dkv_turn_wait(wg);\n        wgmma_fence();\n#pragma unroll\n"
         "        for (int kk = 0; kk < BQ / 16; ++kk) {"),
        ("mma_rs<D>(dk, da[kk], mnmajor(qs, BQ, kk));\n        }\n        wgmma_commit();",
         "mma_rs<D>(dk, da[kk], mnmajor(qs, BQ, kk));\n        }\n        wgmma_commit();\n"
         "        dkv_turn_pass(wg);")],
    # K19: three stages of q, dout, lse and di at head_dim 64 (checked)
    "dkv 3 stages": [("static constexpr int kStages = D == 64 ? 4 : 2;",
                      "static constexpr int kStages = D == 64 ? 3 : 2;")],
    # K18: the exponentials of p (s log2 e - lse log2 e kept as it is)
    "dq no exp": [("s[4 * jj + e] = ex2(keep ? fmaf(s[4 * jj + e], kLog2e, -lse2[rr]) : -INFINITY);",
                   "s[4 * jj + e] = keep ? fmaf(s[4 * jj + e], kLog2e, -lse2[rr]) : 0.f;")],
    # K18: the S = q k^T wgmmas
    "dq no S": [("for (int kk = 0; kk < D / 16; ++kk)\n          mma_ss<kBc>(s,",
                 f"for (int kk = 0; {_NEVER} && kk < D / 16; ++kk)\n          mma_ss<kBc>(s,")],
    # K18: the dP = dout v^T wgmmas
    "dq no dP": [("          mma_ss<kBc>(dp, kmajor_step(o_desc,",
                  f"          if ({_NEVER}) mma_ss<kBc>(dp, kmajor_step(o_desc,")],
    # K18: the dq += dS k wgmmas
    "dq no dS.k": [("for (int kk = 0; kk < kSteps; ++kk) mma_rs<D>(dq, da[kk], mnmajor_step(k_desc, kk));",
                    f"for (int kk = 0; {_NEVER} && kk < kSteps; ++kk) "
                    "mma_rs<D>(dq, da[kk], mnmajor_step(k_desc, kk));")],
    # K18 with FlashAttention-3's ping-pong: a warpgroup holds the turn from
    # issuing S_j (dP_j, dS_{j-1} k_{j-1}) until S_j is done, so that one's
    # exponentials run while the other's products do; a turn for each kv
    # tile (checked)
    "dq pingpong": [
        ("group of S and dP,\n  // columns 2 (t % 4) and + 1.\n  const int t = threadIdx.x % 128;\n"
         "  const int r = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);\n",
         "group of S and dP,\n  // columns 2 (t % 4) and + 1.\n  const int t = threadIdx.x % 128;\n"
         "  const int r = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);\n"
         "  if (wg == 1) turn_pass(wg);\n"),
        ("      issue_s(kv_stage(it));\n      if (n > 0 && t == 0)",
         "      turn_wait(wg);\n      issue_s(kv_stage(it));\n      if (n > 0 && t == 0)"),
        ("      wgmma_wait<0>();\n      fence_acc(s);\n      // Tile j",
         "      wgmma_wait<0>();\n      turn_pass(wg);\n      fence_acc(s);\n      // Tile j"),
        ("          issue_s(kv_stage(cur));\n          issue_dq(kv_stage(prev));\n"
         "          wgmma_wait<1>();  // S_j is done; dS_{j-1} k_{j-1} may run on\n",
         "          turn_wait(wg);\n          issue_s(kv_stage(cur));\n          issue_dq(kv_stage(prev));\n"
         "          wgmma_wait<1>();  // S_j is done; dS_{j-1} k_{j-1} may run on\n"
         "          turn_pass(wg);\n"),
        ("        if (t == 0) mbar_arrive(kv_empty + 8 * (cur % S));\n      }\n      it += nkv;",
         "        if (t == 0) mbar_arrive(kv_empty + 8 * (cur % S));\n        turn_wait(wg);\n"
         "        turn_pass(wg);\n      }\n      it += nkv;")],
    # K18 with a quarter of the exponentials on the FMA pipe (a degree-5
    # polynomial of 2^f after rounding x by the 1.5 2^23 shift), beside the
    # special function unit's ex2 for the rest (checked)
    "dq poly exp": [
        ("constexpr float kLog2e = 1.4426950408889634f;\n",
         "constexpr float kLog2e = 1.4426950408889634f;\n"
         "__device__ __forceinline__ float ex2_fma(float x) {\n"
         "  x = fmaxf(x, -127.f);\n"
         "  const float j = x + 12582912.f;\n"
         "  const float f = x - (j - 12582912.f);\n"
         "  float p = fmaf(fmaf(fmaf(fmaf(fmaf(1.3333558e-3f, f, 9.6181291e-3f), f, 5.5504109e-2f), f,\n"
         "                      2.4022651e-1f), f, 6.9314718e-1f), f, 1.f);\n"
         "  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(j) << 23));\n"
         "}\n"),
        ("            s[4 * jj + e] = ex2(keep ? fmaf(s[4 * jj + e], kLog2e, -lse2[rr]) : -INFINITY);",
         "            const float xx = fmaf(s[4 * jj + e], kLog2e, -lse2[rr]);\n"
         "            s[4 * jj + e] = jj % 4 == 3 ? (keep ? ex2_fma(xx) : 0.f) : ex2(keep ? xx : -INFINITY);")],
    # K18 with dP_j issued beside S_j, before the exponentials (checked)
    "dq early dP": [("      issue_s(kv_stage(it));\n      if (n > 0 && t == 0)",
                     "      issue_s(kv_stage(it));\n      issue_dp(kv_stage(it));\n"
                     "      if (n > 0 && t == 0)"),
                    ("          issue_s(kv_stage(cur));\n          issue_dq(kv_stage(prev));\n",
                     "          issue_s(kv_stage(cur));\n          issue_dp(kv_stage(cur));\n"
                     "          issue_dq(kv_stage(prev));\n"),
                    ("        issue_dp(kv_stage(cur));\n        wgmma_wait<0>();\n        fence_acc(dp);\n",
                     "        fence_acc(dp);\n")],
    # K18 on K17's schedule: a unit is one q tile, the last q tiles of every
    # head first (checked)
    "dq longest first": [("__host__ __device__ constexpr int dq_units(int tiles) { return (tiles + 1) / 2; }",
                          "__host__ __device__ constexpr int dq_units(int tiles) { return tiles; }"),
                         ("  const int per = dq_units(s.tiles);\n  bh = u / per;\n"
                          "  const int p = u - bh * per;\n  hi = s.tiles - 1 - p;\n  lo = p < hi ? p : -1;",
                          "  ws_item(s, true, u, bh, hi);\n  lo = -1;")],
    # K18: six stages of k and v at head_dim 64 (checked)
    "dq 6 stages": [("static constexpr int kStages = D == 128 ? 2 : 4;",
                     "static constexpr int kStages = D == 128 ? 2 : 6;")],
}
CHECKED = ("full", "fwd no turns", "fwd 2 stages", "fwd kv rows", "dkv turns", "dkv 3 stages",
           "dq early dP", "dq longest first", "dq 6 stages", "dq pingpong", "dq poly exp")


def patched(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches; raises if one does not
    apply once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"probe variant {name!r}: its patch does not apply: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def build_variant(name: str):
    out = OUT / "src" / name.replace(" ", "_").replace(".", "").replace("/", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE).write_text(patched(name, (kbuild.CSRC / SOURCE).read_text()))
    for header in kbuild.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    return cmp.build_lib(out, name, OUT)


def check(name: str, lib, xs) -> None:
    for kernel in KERNELS:
        got = tuple(x.clone() for x in cmp.call_of(lib, kernel, *xs)())
        c = cmp.check_outputs(got, cmp.plain_of(kernel, *xs), torch.bfloat16)
        if not c["ok"]:
            raise RuntimeError(f"{name} {kernel}: {c}")


def run(variants: list[str]) -> dict:
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(build_variant, variants)))
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with torch.no_grad():
        for label, shape in cmp.SHAPES:
            xs = cmp.inputs(shape, torch.bfloat16, g)
            for v in [v for v in CHECKED if v in libs]:
                check(v, libs[v], xs)
            for kernel in KERNELS:
                times = cmp.in_turns({v: cmp.call_of(lib, kernel, *xs) for v, lib in libs.items()})
                print(f"{label} {shape} {kernel}, ms: "
                      + ", ".join(f"{v} {ms:.5f}" for v, ms in times.items()), flush=True)
                out[f"{label} {kernel}"] = times
            del xs
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=None,
                    help="only these variants (beside \"full\"); default all")
    args = ap.parse_args(argv)
    benchlib.require_card("probe_attention")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    chosen = list(VARIANTS)
    if args.variants is not None:
        unknown = set(args.variants) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"probe_attention: no variants {sorted(unknown)}")
        chosen = [v for v in VARIANTS if v == "full" or v in args.variants]
    return run(chosen)


if __name__ == "__main__":
    main()
