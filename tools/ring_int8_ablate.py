#!/usr/bin/env python3
"""Ablation builds of the int8 ring carry (`ring_carry_s8` on `wgmma_s8`).

    python3 tools/ring_int8_ablate.py

Needs a CUDA card and nvcc.  Each variant is a copy of
``deepspeed_tpu_torch/ops/csrc`` with one edit to ``attention_wgmma.cuh``,
built with the op builder's flags under ``build/ablate/<variant>`` and
loaded in place of the int8 lanes' library; the carry then runs at
chip_smoke.py's path hop (llama3-8b heads 32/8, S_l 4096, D 128, striped
hop 1) and is timed by CUDA graph (chip_smoke.cuda_time_ms), two rounds,
the second in reverse order.  Variants:

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

Prints one JSON line a variant build (ptxas spill bytes of the D 128
kernel) and a timed run (ms, max |acc/l - plain|), then a summary line.
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


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"the source no longer holds the text this ablation edits:\n{old}")
    return src.replace(old, new)


def no_convert(src: str) -> str:
    return _edit(src, CONVERT, "  const uint2 a = make_uint2(raw.x, raw.y), "
                               "b = make_uint2(raw.z, raw.w), e = a, f = b;")


def no_lo(src: str) -> str:
    return _edit(src, LO, "          ;")


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
        raise SystemExit("the source no longer holds widen_s8x4")
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


VARIANTS = {"base": lambda s: s, "no_convert": no_convert, "no_lo": no_lo,
            "late_v": late_v, "packed_convert": packed_convert}


def build(name: str):
    """The variant's int8 library: (name, path or None, D-128 spill bytes)."""
    from deepspeed_tpu_torch.ops import op_builder

    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(SRC, d)
    header = d / "attention_wgmma.cuh"
    header.write_text(VARIANTS[name](header.read_text()))
    lib = d / "ring_attention_int8.so"
    r = subprocess.run([op_builder._nvcc(), *op_builder.NVCC_FLAGS, "-o", str(lib),
                        str(d / "ring_attention_int8.cu")], capture_output=True, text=True)
    log = r.stdout + r.stderr
    spill = re.findall(r"attn_fwd_wgmma_s8_kernelILi128.*?\n.*?(\d+) bytes spill stores", log)
    if r.returncode:
        print(log[-3000:], file=sys.stderr)
        return name, None, spill
    return name, lib, spill


def main() -> int:
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.comm import quantized as codec
    from deepspeed_tpu_torch.ops import flash_mha as fm

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(build, VARIANTS))
    for name, lib, spill in built:
        print(json.dumps({"variant": name, "built": lib is not None,
                          "spill_store_bytes_d128": [int(x) for x in spill]}))
    b, hq, hkv, s, d = 1, 32, 8, 4096, 128
    pos = (1, 2, 0, 2)
    q, k, v, _ = cs.bshd_inputs(b, hq, hkv, s, d, torch.bfloat16, seed=16)
    (kp, ks), (vp, vs) = (codec.wire_encode_rows(x, "int8") for x in (k, v))
    wire = dict(k_scale=ks[..., 0], v_scale=vs[..., 0])
    scale = d ** -0.5

    def fresh():
        return (torch.full((b, hq, s), fm.NEG_INF, device="cuda"),
                torch.zeros((b, hq, s), device="cuda"),
                torch.zeros((b, hq, s, d), device="cuda"))

    ref = fresh()
    fm.ring_carry_ref(q, kp, vp, *ref, pos, True, scale, **wire)
    want = ref[2] / ref[1].clamp(min=1e-20)[..., None]
    real = fm._ring_int8_lib
    tail = [fm._STRIDES] + [fm._I] * 5 + [fm._F] + [fm._I] * 6 + [fm._P]
    order = [(name, lib) for name, lib, _ in built if lib is not None]
    times = {}
    try:
        for rnd in range(2):
            for name, path in (order if rnd == 0 else order[::-1]):
                lib = ctypes.CDLL(str(path))
                lib.ring_carry_s8.argtypes = [fm._I] + [fm._P] * 8 + tail
                lib.ring_carry_s8.restype = fm._I
                fm._ring_int8_lib = lambda lib=lib: lib
                st = fresh()
                fm.flash_carry_block(q, kp, vp, *st, pos, sm_scale=scale, **wire)
                torch.cuda.synchronize()
                err = float((st[2] / st[1].clamp(min=1e-20)[..., None] - want).abs().max())
                ms = cs.cuda_time_ms(lambda: fm.flash_carry_block(
                    q, kp, vp, *st, pos, sm_scale=scale, **wire))
                times.setdefault(name, []).append(ms)
                print(json.dumps({"variant": name, "round": rnd, "ms": ms,
                                  "max_abs_err_acc_over_l": err}))
    finally:
        fm._ring_int8_lib = real
    print(json.dumps({"summary_ms": times, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
