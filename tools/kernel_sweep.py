#!/usr/bin/env python3
"""Hand-written kernels under other compile-time constants, and with a
phase left out, on one GPU: how the constants of K4, K4b, the 1x1
forwards (K12's and K11's), the 1x1 backward (K12's and K11's) and K13
were chosen, and where their time goes.

    python3 tools/kernel_sweep.py [FAMILY ...]   (default: every family)

A family (``FAMILIES``) names a source of ``mimo_unet_torch/csrc``, its
constants and the values to try (the source's own first), the phases to
leave out (loop heads or statements replaced so that they do nothing),
and the kinds of ``tools/train_elem_ab.py`` call sites it runs at (those
of ``chip_smoke.py`` phases 3, 5, 7, 10 and 13).  Every variant is a
whole kernel library built by ``train_elem_ab.variant_libraries``, all
compiled at once; ptxas's registers and spills of the family's kernels
are printed for each.  At each site the script holds every variant's
output against the source's own (bitwise; the 1x1 backward: dy or dz
bitwise, its sums at ``chip_smoke.py``'s tolerance), prints each one's
time (``chip_smoke.cuda_ms``: device time of 20 calls queued behind a
device-side wait, after a warm-up) and its share of the byte bound
(inputs read once, outputs written once),
then the times of the builds with a phase left out, whose outputs are
not the function's and are not checked, beside the whole kernel's.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K13: the forward without its output rows, or without its W lerp too;
# the backward without its W transpose, or without both transposes
_OUT_ROWS = ("for (int r = r0; r < r1; ++r) {  // y(r", "for (int r = r1; r < r1; ++r) {  // y(r")
_W_LERP = ("for (int j = 0; j < j1 - j0; ++j) {", "for (int j = 0; j < 0; ++j) {")
_H_T = ("for (int R = tid / nf, k = tid % nf; R < nr;) {",
        "for (int R = tid / nf, k = tid % nf; R < 0;) {")
_W_T = ("for (int d = d0 + tid; d < d1; d += UP_THREADS) {",
        "for (int d = d1; d < d1; d += UP_THREADS) {")
# K4 and K4b without their output rows: their staging alone
_K4_ROWS = ("    if (e < e1)\n      for (int j = 0; j < nr; ++j) {",
            "    if (e < e1)\n      for (int j = 0; j < 0; ++j) {")
_K4B_ROWS = ("    if (d < d1)\n      for (int j = 0; j < nr; ++j) {",
             "    if (d < d1)\n      for (int j = 0; j < 0; ++j) {")
# the 1x1 forwards without their logits' store, or without their compute too
_K12_STORE = ("store_units(out, obuf + b * 8 * ou, p0 * OC, (p0 + cnt) * OC, vec, tid, "
              "K12_THREADS);", "")
_K12_COMPUTE = ("for (int p = tid; p < cnt; p += 2 * K12_THREADS) {",
                "for (int p = cnt; p < cnt; p += 2 * K12_THREADS) {")
# the 1x1 forwards with oc a run-time argument, as the kernel they
# replaced took it: OCMAX accumulators and records, each use under k < oc;
# one instance for each of K12 and K11 instead of eight
_RUNTIME_OC = [
    ("template <bool PRO, int OC>\n__host__ __device__ __forceinline__ constexpr int "
     "fwd_record() {\n  return ((PRO ? 2 : 0) + OC + 3) & ~3;",
     "template <bool PRO>\n__host__ __device__ __forceinline__ constexpr int "
     "fwd_record(int oc) {\n  return ((PRO ? 2 : 0) + oc + 3) & ~3;"),
    ("template <bool PRO, int OC>\n__global__", "template <bool PRO>\n__global__"),
    ("    int c, int bpg, int vec) {\n  extern __shared__ uint4 k12_smem[];\n"
     "  constexpr int RS = fwd_record<PRO, OC>(), W0 = PRO ? 2 : 0;",
     "    int c, int bpg, int vec, int oc) {\n  extern __shared__ uint4 k12_smem[];\n"
     "  constexpr int RSMAX = fwd_record<PRO>(OCMAX), W0 = PRO ? 2 : 0;\n"
     "  const int RS = fwd_record<PRO>(oc);"),
    ("fwd_tile(c, OC);\n  const int yu = units_of(tp, c), ou = units_of(tp, OC);",
     "fwd_tile(c, oc);\n  const int yu = units_of(tp, c), ou = units_of(tp, oc);"),
    ("p0 * OC, (p0 + cnt) * OC, vec", "p0 * oc, (p0 + cnt) * oc, vec"),
    ("r >= W0 && r < W0 + OC)\n      v = bf2f(wo[((int64_t)grp * c + ch) * OC + r - W0]);",
     "r >= W0 && r < W0 + oc)\n      v = bf2f(wo[((int64_t)grp * c + ch) * oc + r - W0]);"),
    ("  float bias[OC];\n#pragma unroll\n  for (int k = 0; k < OC; ++k) bias[k] = bo[grp * OC + k];",
     "  float bias[OCMAX];\n#pragma unroll\n"
     "  for (int k = 0; k < OCMAX; ++k) bias[k] = k < oc ? bo[grp * oc + k] : 0.f;"),
    ("((p0 * OC) & 7)", "((p0 * oc) & 7)"),
    ("float acc[2][OC] = {};", "float acc[2][OCMAX] = {};"),
    ("        float r[RS];\n#pragma unroll\n        for (int j = 0; j < RS; j += 4) {",
     "        float r[RSMAX];\n#pragma unroll\n        for (int j = 0; j < RSMAX; j += 4) {\n"
     "          if (j >= RS) break;"),
    ("for (int k = 0; k < OC; ++k) acc[u][k] = fmaf(",
     "for (int k = 0; k < OCMAX; ++k) if (k < oc) acc[u][k] = fmaf("),
    ("      for (int k = 0; k < OC; ++k) {\n        os[p * OC + k]",
     "      for (int k = 0; k < OCMAX; ++k) {\n        if (k >= oc) break;\n        os[p * oc + k]"),
    ("os[(p + K12_THREADS) * OC + k]", "os[(p + K12_THREADS) * oc + k]"),
    ("template <bool PRO, int OC>\nint fwd_launch(", "template <bool PRO>\nint fwd_launch(int oc, "),
    ("fwd_tile(c, OC);\n  const int64_t bpg", "fwd_tile(c, oc);\n  const int64_t bpg"),
    ("2 * units_of(tp, OC)) +\n                      4 * (size_t)c * fwd_record<PRO, OC>();",
     "2 * units_of(tp, oc)) +\n                      4 * (size_t)c * fwd_record<PRO>(oc);"),
    ("conv1x1_kernel<PRO, OC>, cudaFunc", "conv1x1_kernel<PRO>, cudaFunc"),
    ("conv1x1_kernel<PRO, OC><<<", "conv1x1_kernel<PRO><<<"),
    ("(int)aligned16(y, out, y));\n  return (int)cudaGetLastError();\n}\n\ntemplate <bool PRO>\nint "
     "conv1x1_launch", "(int)aligned16(y, out, y), oc);\n  return (int)cudaGetLastError();\n}\n\n"
     "template <bool PRO>\nint conv1x1_launch"),
    ("  switch (oc) {\n    case 1: return fwd_launch<PRO, 1>(y, sc, sh, wo, bo, out, n, hw, ci, "
     "groups, st);", "  switch (0) {\n    case 1: return 0;"),
    ("    default: return fwd_launch<PRO, 8>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);",
     "    default: return fwd_launch<PRO>((int)oc, y, sc, sh, wo, bo, out, n, hw, ci, groups, st);"),
] + [(f"    case {k}: return fwd_launch<PRO, {k}>(y, sc, sh, wo, bo, out, n, hw, ci, groups, st);\n",
      "") for k in range(2, 8)]

# name: source, kernels (a pattern of their mangled names, for ptxas's
# lines: the 1x1 backward and forward at OC = 2), kinds of sites,
# exactness against the source's own output (or {kind: exactness}),
# constants, their values (the source's own first), module constants of
# kernels/train_elem.py that mirror them, other forms of the kernel (label,
# replacements; checked and timed as the constants are), phases left out
# (label, the kind of site it is timed at or None for every kind,
# replacements)
FAMILIES = {
    "upsample2x": dict(
        source="upsample2x.cu", kernels="up2_", kinds=("upsample2x", "upsample2x_bwd"),
        exact=True, consts=("UP_BAND", "BK_BAND", "BK_TILE"),
        values=[(16, 4, 1024), (16, 8, 512), (8, 4, 512), (8, 8, 256), (32, 16, 256)],
        mirror=None, forms=[],
        phases=[("staging + W lerp", "upsample2x", [_OUT_ROWS]),
                ("staging", "upsample2x", [_OUT_ROWS, _W_LERP]),
                ("staging + H transpose", "upsample2x_bwd", [_W_T]),
                ("staging", "upsample2x_bwd", [_W_T, _H_T])]),
    "prelu_bwd": dict(
        source="train_elem.cu", kernels="affine_bwd_kernelILb[01]ELi2E",
        kinds=("prelu_bwd", "conv1x1_bwd"),
        exact={"prelu_bwd": (True, False, False, False, False),
               "conv1x1_bwd": (True, False, False)},
        consts=("K12_TILE_BYTES", "K12_PER_SM"),
        values=[(16384, 4)] + [(t, b) for t in (4096, 8192, 16384) for b in (3, 4, 5)
                               if (t, b) != (16384, 4)],
        mirror=lambda tile, per_sm: {"K12_TILE_BYTES": tile, "K12_BLOCKS": per_sm * 132},
        forms=[], phases=[]),
    "upsample_w2x": dict(
        source="upsample_w2x.cu", kernels="upsample_w2x_kernel", kinds=("upsample_w2x",),
        exact=True, consts=("K4_STAGE_BYTES", "K4_PER_SM"),
        values=[(8192, 4), (4096, 4), (16384, 4), (8192, 3), (8192, 6)],
        mirror=None, forms=[],
        phases=[("staging", "upsample_w2x", [_K4_ROWS])]),
    "upsample_w2x_bwd": dict(
        source="upsample_w2x.cu", kernels="upsample_w2x_bwd_kernel", kinds=("upsample_w2x_bwd",),
        exact=True, consts=("K4B_THREADS", "K4B_STAGE_BYTES", "K4B_PER_SM"),
        values=[(256, 24576, 3), (256, 8192, 3), (256, 8192, 4), (256, 16384, 3),
                (256, 16384, 4), (256, 32768, 3), (256, 32768, 2), (128, 8192, 4),
                (128, 4096, 6), (512, 16384, 2)],
        mirror=None, forms=[],
        phases=[("staging", "upsample_w2x_bwd", [_K4B_ROWS])]),
    "conv1x1": dict(
        source="train_elem.cu", kernels=r"conv1x1_kernelILb1E(Li2E)?EEv", kinds=("prelu", "conv1x1"),
        exact=True, consts=("K12F_TILE_BYTES", "K12F_PER_SM"),
        values=[(24576, 3), (24576, 4), (49152, 2), (12288, 4)],
        mirror=None, forms=[("run-time oc", _RUNTIME_OC)],
        phases=[("staging + compute", None, [_K12_STORE]),
                ("staging", None, [_K12_STORE, _K12_COMPUTE])]),
}


def variant_source(src, fam, values=None, phase=None):
    """``src`` with the family's constants set to ``values`` (a tuple) or
    with the replacements of its form ``values`` (a label), or with those
    of its phase ``phase`` (an index into its phases)."""
    f = FAMILIES[fam]
    subs = dict(f["forms"]).get(values, []) if isinstance(values, str) else []
    for name, v in zip(f["consts"], values if isinstance(values, tuple) else ()):
        src, n = re.subn(rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{v};", src)
        if n != 1:
            raise RuntimeError(f"{fam}: {name} not found once")
    for a, b in subs + (f["phases"][phase][2] if phase is not None else []):
        if src.count(a) != 1:
            raise RuntimeError(f"{fam} {values or phase}: {a!r} not found once")
        src = src.replace(a, b)
    return src


def _nbytes(*ts):
    import torch

    out = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            out += _nbytes(*t)
        elif isinstance(t, torch.Tensor):
            out += t.numel() * t.element_size()
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("family", nargs="*", help=f"of {list(FAMILIES)} (default: all)")
    fams = ap.parse_args().family or list(FAMILIES)
    if set(fams) - set(FAMILIES):
        ap.error(f"unknown families {sorted(set(fams) - set(FAMILIES))}")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_sweep: CUDA is not available")
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    import chip_smoke as cs
    from train_elem_ab import kernels, sites, variant_libraries, variant_logs
    from mimo_unet_torch.kernels import _build
    from mimo_unet_torch.kernels import train_elem as TE

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    variants = {}
    for fam in fams:
        f = FAMILIES[fam]
        src = (_build.CSRC_DIR / f["source"]).read_text()
        for v in f["values"] + [label for label, _ in f["forms"]]:
            variants[fam, v] = {f["source"]: variant_source(src, fam, values=v).encode()}
        for i in range(len(f["phases"])):
            variants[fam, i] = {f["source"]: variant_source(src, fam, phase=i).encode()}
    libs = variant_libraries(variants)
    for (fam, v), logs in variant_logs.items():
        entry = None
        for line in logs.get(FAMILIES[fam]["source"][:-3], "").splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif entry and re.search(FAMILIES[fam]["kernels"], entry) and \
                    ("registers" in line or "spill" in line):
                tag = FAMILIES[fam]["phases"][v][0] if isinstance(v, int) else v
                print(f"ptxas {fam} {tag} {entry}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    base = _build.load_library()
    kept = {k: getattr(TE, k) for k in ("K12_TILE_BYTES", "K12_BLOCKS")}

    def use(fam, v):
        _build._lib = base if v is None else libs[fam, v]
        mirror = FAMILIES[fam]["mirror"]
        for k, val in (mirror(*v) if mirror and isinstance(v, tuple) else kept).items():
            setattr(TE, k, val)

    dev = torch.device("cuda", 0)
    calls = kernels()
    for label, kind, ts in sites(dev, torch.Generator(device=dev).manual_seed(12),
                                 resample=True, w2x=True):
        fam = next((f for f in fams if kind in FAMILIES[f]["kinds"]), None)
        if fam is None:
            continue
        f, call = FAMILIES[fam], calls[kind][0]
        exact = f["exact"][kind] if isinstance(f["exact"], dict) else f["exact"]
        use(fam, None)
        want = call(*ts)
        bound = _nbytes(ts, want) / cs.PEAK_BYTES * 1e3
        line = []
        for v in f["values"] + [label for label, _ in f["forms"]]:
            use(fam, v)
            cs.compare(f"{label} {v}", call(*ts), want, exact)
            ms = cs.cuda_ms(lambda: call(*ts), 20)
            line.append(f"{v} {ms:.4f} ms ({bound / ms:.0%})")
        print(f"{label} (bound {bound:.4f} ms), ms by {f['consts']} or form: {', '.join(line)} "
              f"({card})", flush=True)
        phases = [i for i, (_, k, _) in enumerate(f["phases"]) if k in (None, kind)]
        if phases:
            use(fam, None)
            line = [f"whole {cs.cuda_ms(lambda: call(*ts), 20):.4f} ms"]
            for i in phases:
                use(fam, i)
                line.append(f"{f['phases'][i][0]} {cs.cuda_ms(lambda: call(*ts), 20):.4f} ms")
            print(f"{label} by phase: {', '.join(line)} ({card})", flush=True)
        use(fam, None)
        del want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
