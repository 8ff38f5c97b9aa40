#!/usr/bin/env python3
"""Ablation builds of the port's int8 ring lanes and its quantize kernel.

    python3 tools/ring_int8_ablate.py [carry|dq|quantize] [--src DIR]

Needs a CUDA card and nvcc.  Each variant is a copy of the kernel sources
(``deepspeed_tpu_torch/ops/csrc``, or ``--src``, e.g. a parent commit's
unpacked from ``git archive``) with one edit, built with the op builder's
flags under ``build/ablate/<target>/<variant>`` and loaded in place of the
kernel's library; the kernel then runs at chip_smoke.py's path shape and
is timed by CUDA graph (chip_smoke.cuda_time_ms), two rounds, the second
in reverse order.  A variant whose text the source does not hold is
skipped.  Targets and variants:

  carry     ``ring_carry_s8`` on ``wgmma_s8`` at the path hop (llama3-8b
            heads 32/8, S_l 4096, D 128, striped hop 1):
    base            the source as it is;
    no_convert      the widening stores the payload bytes unconverted (what
                    the int8 -> bf16 arithmetic costs; wrong numbers);
    no_lo           P.V without the lo parts' products (what they cost;
                    numbers off by p vs's lo part);
    late_v          the consumers wait for V after the softmax, p kept in
                    fp32 and split against the V scales then (exact);
    packed_convert  the widening as packed bf16 arithmetic: x =
                    bf16(0x4300 | (x & 0x7F)) - bf16(0x4300 | (x & 0x80)),
                    four instructions a pair (exact).
  dq        ``ring_bwd_dq_s8`` on ``wgmma_s8`` at the same hop, beside the
            bf16 lane (``ring_bwd_dq`` on ``wgmma``) on the same q, do and
            the undecoded bf16 K/V:
    base, no_convert  as the carry's;
    no_lo           dQ += dS.K without the lo parts' products;
    widen_batch2, widen_batch3, widen_batch6
                    each widening thread loads 2, 3 or 6 (at D 128 all) of
                    its 16-byte chunks of a slot before it converts and
                    stores the first of them (widen_slot; exact).
  quantize  ``quantize`` at the linear-kernels path case ([4096, 14336]
            bf16, group 512, int8):
    base            the source as it is (``fake_quantize`` timed beside, as
                    for every exact variant);
    div_as_mul      x / scale as x * (1 / scale) with no tie check (wrong
                    numbers where the two round apart);
    no_store        the payload's stores removed (the quantize arithmetic
                    goes with them; the scales are still written);
    grid_all        a block for every 8 warps' steps, not the card's
                    resident blocks: a warp takes one step (exact);
    warps4          blocks of 4 warps, not 8 (exact);
    plain_ldst      plain loads and stores for the streaming ones (exact).

Prints one JSON line a variant build (ptxas spill bytes of the kernel in
question) and a timed run (ms, and the max error against the plain version
or the count of payload bytes and scales that differ), then a summary
line.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SRC = ROOT / "deepspeed_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "ablate"

CONVERT = """  const uint2 a = widen_s8x4(raw.x), b = widen_s8x4(raw.y), e = widen_s8x4(raw.z),
              f = widen_s8x4(raw.w);"""
LO = """          pv_mma<D>(o_acc, p_lo[kc], desc_sw128(v_addr + kc * 2048, kBox, kAtomRows));"""
DQ_LO = """        for (int kc = 0; kc < kBKd / 16; ++kc) sum_mma<D>(dq_acc, ds_lo[kc], k_addr + kc * 2048);"""
PACK = """        if constexpr (Q8) {
          const float2 vc = *reinterpret_cast<const float2*>(vsc_t + 8 * j + 2 * tq);
          split_pack(pe[0] * vc.x, pe[1] * vc.y, p[j / 2][2 * (j % 2)], p_lo[j / 2][2 * (j % 2)]);
          split_pack(pe[2] * vc.x, pe[3] * vc.y, p[j / 2][2 * (j % 2) + 1],
                     p_lo[j / 2][2 * (j % 2) + 1]);
        } else {"""
EARLY_V = """        vsc_t = vsc + stage * kBK;
        mbar_wait(&v_full[stage], phase);
      }"""
LATE_V = """      if constexpr (!Q8) mbar_wait(&v_full[stage], phase);"""
WIDEN = re.compile(r"__device__ __forceinline__ uint2 widen_s8x4\(uint32_t w\) \{.*?\n\}\n",
                   re.S)
QUANT1 = re.compile(r"(__device__ __forceinline__ float quant1\([^)]*\)) \{.*?\n\}\n", re.S)
# the payload stores of quantize.cu, before and after its redesign
Q_STORES = ("      *reinterpret_cast<char4*>(q + base + 4 * j) = to_char4(qv);",
            "      __stcs(reinterpret_cast<uint2*>(q + at), make_uint2(pack_s8x4(f), pack_s8x4(f + 4)));",
            "      __stcs(reinterpret_cast<unsigned int*>(q + at), pack_s8x4(f));")


WIDEN_LOOP = """  for (int x = u; x < ROWS * kPerRow; x += kWideners)
    store_widened(dst, ROWS * 128, x / kPerRow, x % kPerRow, hopper::lds_v4(src + 16 * x));"""
GRID = "std::min<long long>((warps + kWarps - 1) / kWarps, resident)"
WARPS = "constexpr int kWarps = 8; "
LDST = "#include <type_traits>\n"


class Missing(Exception):
    """The source holds none of the text a variant edits."""


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise Missing(old)
    return src.replace(old, new)


def no_convert(src: str) -> str:
    return _edit(src, CONVERT, "  const uint2 a = make_uint2(raw.x, raw.y), "
                               "b = make_uint2(raw.z, raw.w), e = a, f = b;")


def no_lo(src: str) -> str:
    return _edit(src, LO, "          ;")


def dq_no_lo(src: str) -> str:
    return _edit(src, DQ_LO, "        ;")


def late_v(src: str) -> str:
    src = _edit(src, PACK, """        if constexpr (Q8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s_acc[4 * j + e] = pe[e];
        } else {""")
    src = _edit(src, EARLY_V, """        vsc_t = vsc + stage * kBK;
      }""")
    return _edit(src, LATE_V, """      mbar_wait(&v_full[stage], phase);
      if constexpr (Q8) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float2 vc = *reinterpret_cast<const float2*>(vsc_t + 8 * j + 2 * tq);
          split_pack(s_acc[4 * j] * vc.x, s_acc[4 * j + 1] * vc.y, p[j / 2][2 * (j % 2)],
                     p_lo[j / 2][2 * (j % 2)]);
          split_pack(s_acc[4 * j + 2] * vc.x, s_acc[4 * j + 3] * vc.y,
                     p[j / 2][2 * (j % 2) + 1], p_lo[j / 2][2 * (j % 2) + 1]);
        }
      }""")


def packed_convert(src: str) -> str:
    if not WIDEN.search(src):
        raise Missing("widen_s8x4")
    return WIDEN.sub(lambda _m: """__device__ __forceinline__ uint2 widen_s8x4(uint32_t w) {
  uint32_t r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t p = __byte_perm(w, 0u, h ? 0x4342u : 0x4140u);
    const uint32_t m = (p & 0x007F007Fu) | 0x43004300u, n = (p & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                                     *reinterpret_cast<const __nv_bfloat162*>(&n));
    r[h] = *reinterpret_cast<const uint32_t*>(&d);
  }
  return make_uint2(r[0], r[1]);
}
""", src, count=1)


def widen_batched(n: int):
    """Each widening thread loads n of its 16-byte chunks of a slot before
    it converts and stores the first of them."""
    def edit(src: str) -> str:
        return _edit(src, WIDEN_LOOP, f"""  constexpr int kChunks = ROWS * kPerRow, kBatch = {n};
  for (int x0 = u; x0 < kChunks; x0 += kBatch * kWideners) {{
    uint4 raw[kBatch];
#pragma unroll
    for (int c = 0; c < kBatch; ++c)
      if (x0 + kWideners * c < kChunks) raw[c] = hopper::lds_v4(src + 16 * (x0 + kWideners * c));
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {{
      const int x = x0 + kWideners * c;
      if (x < kChunks) store_widened(dst, ROWS * 128, x / kPerRow, x % kPerRow, raw[c]);
    }}
  }}""")
    return edit


def grid_all(src: str) -> str:
    return _edit(src, GRID, "(warps + kWarps - 1) / kWarps")


def warps4(src: str) -> str:
    return _edit(src, WARPS, "constexpr int kWarps = 4; ")


def plain_ldst(src: str) -> str:
    return _edit(src, LDST, LDST + "#define __ldcs(p) (*(p))\n#define __stcs(p, v) (*(p) = (v))\n")


def div_as_mul(src: str) -> str:
    if not QUANT1.search(src):
        raise Missing("quant1")
    return QUANT1.sub(lambda m: m.group(1) + """ {
  return fminf(fmaxf(rintf(x * __frcp_rn(scale)), -qmax - 1.f), qmax);
}
""", src, count=1)


def no_store(src: str) -> str:
    hits = [ln for ln in Q_STORES if ln in src]
    if not hits:
        raise Missing(Q_STORES[0])
    for ln in hits:
        src = src.replace(ln, "      ;")
    return src


def same(src: str) -> str:
    return src


# target: (the edited file, the library built, its kernel in ptxas's report,
# the variants: name -> edit)
TARGETS = {
    "carry": ("attention_wgmma.cuh", "ring_attention_int8", "attn_fwd_wgmma_s8_kernelILi128",
              {"base": same, "no_convert": no_convert, "no_lo": no_lo, "late_v": late_v,
               "packed_convert": packed_convert}),
    "dq": ("attention_wgmma_bwd.cuh", "ring_attention_int8", "attn_bwd_dq_wgmma_s8_kernelILi128",
           {"base": same, "no_convert": no_convert, "no_lo": dq_no_lo,
            "widen_batch2": widen_batched(2), "widen_batch3": widen_batched(3),
            "widen_batch6": widen_batched(6)}),
    "quantize": ("quantize.cu", "quantize", "quant_kernelI13__nv_bfloat16Lb0E",
                 {"base": same, "div_as_mul": div_as_mul, "no_store": no_store,
                  "grid_all": grid_all, "warps4": warps4, "plain_ldst": plain_ldst}),
}


def build(target: str, src_dir: Path, name: str):
    """The variant's library: (name, path or None, spill bytes of the
    target's kernel, None if the source lacks the variant's text)."""
    from deepspeed_tpu_torch.ops import op_builder

    edited, lib_name, kernel, variants = TARGETS[target]
    d = OUT / target / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    # the int8 lanes' widening (store_widened, widen_slot) lives in the
    # forward's header, whichever walk runs it
    missing = None
    for path in dict.fromkeys((d / edited, d / "attention_wgmma.cuh")):
        try:
            path.write_text(variants[name](path.read_text()))
            break
        except Missing as e:
            missing = e
    else:
        print(json.dumps({"target": target, "variant": name, "skipped":
                          f"the source holds no {str(missing)[:80]!r}"}))
        return name, None, None
    lib = d / f"{lib_name}.so"
    r = subprocess.run([op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-o", str(lib),
                        str(d / f"{lib_name}.cu")], capture_output=True, text=True)
    log = r.stdout + r.stderr
    spill = re.findall(kernel + r".*?\n.*?(\d+) bytes spill stores", log)
    if r.returncode:
        print(log[-3000:], file=sys.stderr)
        return name, None, spill
    return name, lib, spill


def _rounds(order, run):
    """Two rounds over ``order`` ((name, library path) pairs), the second
    reversed: ``run(name, ctypes library, round)`` -> ms; the times by
    name."""
    times = {}
    for rnd in range(2):
        for name, path in (order if rnd == 0 else order[::-1]):
            times.setdefault(name, []).append(run(name, ctypes.CDLL(str(path)), rnd))
    return times


def ring_case():
    """The path hop's operands: q, do, bf16 k, v, their int8 payloads and
    scales, the position tuple and the softmax scale."""
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.comm import quantized as codec

    b, hq, hkv, s, d = 1, 32, 8, 4096, 128
    q, k, v, do = cs.bshd_inputs(b, hq, hkv, s, d, torch.bfloat16, seed=16)
    (kp, ks), (vp, vs) = (codec.wire_encode_rows(x, "int8") for x in (k, v))
    wire = dict(k_scale=ks[..., 0], v_scale=vs[..., 0])
    return q, do, k, v, kp, vp, wire, (1, 2, 0, 2), d ** -0.5


def time_carry(order):
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import flash_mha as fm

    q, _do, _k, _v, kp, vp, wire, pos, scale = ring_case()
    b, hq, s, d = q.shape

    def fresh():
        return (torch.full((b, hq, s), fm.NEG_INF, device="cuda"),
                torch.zeros((b, hq, s), device="cuda"),
                torch.zeros((b, hq, s, d), device="cuda"))

    ref = fresh()
    fm.ring_carry_ref(q, kp, vp, *ref, pos, True, scale, **wire)
    want = ref[2] / ref[1].clamp(min=1e-20)[..., None]
    tail = [fm._STRIDES] + [fm._I] * 5 + [fm._F] + [fm._I] * 6 + [fm._P]

    def run(name, lib, rnd):
        lib.ring_carry_s8.argtypes = [fm._I] + [fm._P] * 8 + tail
        lib.ring_carry_s8.restype = fm._I
        fm._ring_int8_lib = lambda: lib
        st = fresh()
        fm.flash_carry_block(q, kp, vp, *st, pos, sm_scale=scale, **wire)
        torch.cuda.synchronize()
        err = float((st[2] / st[1].clamp(min=1e-20)[..., None] - want).abs().max())
        ms = cs.cuda_time_ms(lambda: fm.flash_carry_block(
            q, kp, vp, *st, pos, sm_scale=scale, **wire))
        print(json.dumps({"target": "carry", "variant": name, "round": rnd, "ms": ms,
                          "max_abs_err_acc_over_l": err}))
        return ms

    return _rounds(order, run), {}


def time_dq(order):
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import flash_mha as fm

    q, do, k, v, kp, vp, wire, pos, scale = ring_case()
    b, hq, s, d = q.shape
    gen = torch.Generator(device="cuda").manual_seed(17)
    m, l, acc = (torch.full((b, hq, s), fm.NEG_INF, device="cuda"),
                 torch.zeros((b, hq, s), device="cuda"),
                 torch.zeros((b, hq, s, d), device="cuda"))
    fm.ring_carry_ref(q, kp, vp, m, l, acc, pos, True, scale, **wire)
    lse = (m + torch.log(l.clamp(min=1e-20))).contiguous()
    delta = torch.randn((b, hq, s), generator=gen, device="cuda") * 0.1
    dq0 = torch.randn((b, hq, s, d), generator=gen, device="cuda") * 0.1
    want = dq0.clone()
    fm.ring_bwd_dq_ref(q, kp, vp, do, lse, delta, want, pos, True, scale, **wire)
    tail = [fm._STRIDES] + [fm._I] * 5 + [fm._F] + [fm._I] * 6 + [fm._P]
    # the bf16 lane on the same q, do and the bf16 K/V the payloads encode
    bf16 = dq0.clone()
    bf16_ms = [cs.cuda_time_ms(lambda: fm.flash_ring_dq_block(
        q, k, v, do, lse, delta, bf16, pos, sm_scale=scale))]

    def run(name, lib, rnd):
        lib.ring_bwd_dq_s8.argtypes = [fm._I] + [fm._P] * 9 + tail
        lib.ring_bwd_dq_s8.restype = fm._I
        fm._ring_int8_lib = lambda: lib
        got = dq0.clone()
        fm.flash_ring_dq_block(q, kp, vp, do, lse, delta, got, pos, sm_scale=scale, **wire)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = cs.cuda_time_ms(lambda: fm.flash_ring_dq_block(
            q, kp, vp, do, lse, delta, got, pos, sm_scale=scale, **wire))
        print(json.dumps({"target": "dq", "variant": name, "round": rnd, "ms": ms,
                          "max_abs_err_dq": err}))
        return ms

    times = _rounds(order, run)
    bf16_ms.append(cs.cuda_time_ms(lambda: fm.flash_ring_dq_block(
        q, k, v, do, lse, delta, bf16, pos, sm_scale=scale)))
    return times, {"bf16_lane_ms": bf16_ms}


def time_quantize(order):
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import quantize as qk

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn((4096, 14336), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    q_r, s_r = qk.quantize_ref(x, 8, 512)

    f_r = qk.fake_quantize_ref(x, 8, 512)
    fake = {}

    def run(name, lib, rnd):
        lib.quantize.argtypes = [qk._I, qk._P, qk._P, qk._P, qk._L, qk._I, qk._I, qk._F, qk._P]
        lib.fake_quantize.argtypes = [qk._I, qk._P, qk._P, qk._L, qk._I, qk._I, qk._F, qk._P]
        lib.quantize.restype = lib.fake_quantize.restype = qk._I
        qk._lib = lambda: lib
        q, s = qk.quantize(x, 8, 512)
        torch.cuda.synchronize()
        # no_store writes no payload: its scales alone are compared
        bad = int((s != s_r).sum()) + (0 if name == "no_store" else int((q != q_r).sum()))
        ms = cs.cuda_time_ms(lambda: qk.quantize(x, 8, 512))
        row = {"target": "quantize", "variant": name, "round": rnd, "ms": ms,
               "values_off": bad}
        if name not in ("div_as_mul", "no_store"):   # fake_quantize, the same kernel
            row["fake_quantize_equal"] = bool(torch.equal(qk.fake_quantize(x, 8, 512), f_r))
            row["fake_quantize_ms"] = cs.cuda_time_ms(lambda: qk.fake_quantize(x, 8, 512))
            fake.setdefault(name, []).append(row["fake_quantize_ms"])
        print(json.dumps(row))
        return ms

    return _rounds(order, run), {"fake_quantize_ms": fake}


def main() -> int:
    import torch

    from deepspeed_tpu_torch.ops import flash_mha as fm
    from deepspeed_tpu_torch.ops import quantize as qk

    args = sys.argv[1:]
    target = args[0] if args and not args[0].startswith("--") else "carry"
    src_dir = Path(args[args.index("--src") + 1]).resolve() if "--src" in args else SRC
    if target not in TARGETS:
        print(f"no target {target!r}: {sorted(TARGETS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    variants = TARGETS[target][3]
    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda n: build(target, src_dir, n), variants))
    for name, lib, spill in built:
        if spill is not None:
            print(json.dumps({"target": target, "variant": name, "built": lib is not None,
                              "spill_store_bytes": [int(x) for x in spill]}))
    order = [(name, lib) for name, lib, _ in built if lib is not None]
    real = (fm._ring_int8_lib, qk._lib)
    try:
        times, extra = {"carry": time_carry, "dq": time_dq,
                        "quantize": time_quantize}[target](order)
    finally:
        fm._ring_int8_lib, qk._lib = real
    print(json.dumps({"target": target, "src": str(src_dir), "summary_ms": times, **extra,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
