#!/usr/bin/env python3
"""Where the flash kernel's hd-64 and hd-80 routes spend their time on one
card, by subtraction: variants of ``csrc/flash_attention.cu`` with a part
of the work taken out or the schedule changed, timed beside the kernel as
it stands.

  python3 tools/flash_profile.py    # from the repo root; one CUDA card

Each variant is the source with the textual patches of ``VARIANTS``
applied (each patch must match exactly as often as it says), built with
the port's nvcc flags into ``build/flash_profile/<variant>/`` (one nvcc
each, all at once), loaded with ctypes and timed at ``SHAPES`` with
chip_smoke's Timer: profiler device time and CUDA events, the L2 cache
flushed before every call. A variant that drops work computes a wrong
output: only its time is read. The others are held to the kernel's bits.

  full        the kernel as it stands
  rows64      hd 64 always in 64-row blocks (one warpgroup, two an SM)
  rows128     hd 64 always in 128-row blocks (two warpgroups, one an SM)
  no_mask     no tile masked: edge tiles run the interior's softmax
  no_softmax  S goes to P V as it is: no scale, max, exp or sum
  no_pv       no P V products (the softmax still feeds P's registers)
  s_only      neither softmax nor P V: the loads and the S products
  no_loop     no key tile at all: a block's fixed cost (barriers, Q's
              load, the output's store)
  producer    a producer warpgroup issues every TMA load, three tiles
              ahead, and drops to 24 registers with setmaxnreg; the
              consumer warpgroups rise to 240 (232 at one consumer) and
              run the loop as before
  producer4   the same with a 4-stage ring (hd 64 and 80 only: hd 128's
              tiles do not fit four stages)
  qfast       query tiles on the grid's fast axis (B and H on its slow
              ones), so the query tiles of one head run in the same wave
              and share its K/V tiles in L2

Prints the card's name and power limit, ptxas' registers and spills of
every variant's wgmma instances, the SASS instruction counts of the
kernel's wgmma instances (``cuobjdump``), and one JSON line per variant:
device and events ms at each shape, beside SDPA's on the same inputs.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_profile"
# name: B, Sq, Skv, H, K, hd, causal
SHAPES = {
    "zamba2_causal_b2_s2048": (2, 2048, 2048, 32, 32, 80, True),
    "zamba2_causal_b8_s512": (8, 512, 512, 32, 32, 80, True),
    "whisper_encoder_1500": (1, 1500, 1500, 20, 20, 64, False),
    "whisper_encoder_b8_1500": (8, 1500, 1500, 20, 20, 64, False),
    "glm4_causal_b2_s2048": (2, 2048, 2048, 32, 2, 128, True),
}

SOFTMAX = "softmax(sc, m, l, corr, kv0, need_mask(kv0));"
PV = """      wgmma_rs(acc, pa + 4 * kk, sdesc(vt + kk * 2048, KV_BOX, 1024));
      if constexpr (C1 > 0)
        wgmma_rs(acc1, pa + 4 * kk,
                 sdesc32(vt + KV_P1 + kk * 512, KV_P1, 256));
"""
NTILES = "  const int n_tiles = max(0, (kv_hi + BKV - 1) / BKV - tile_lo);"
RULE = "  return (long)B * H * ((Sq + 127) / 128) < 2L * sms ? 64 : 128;"
NO_SOFTMAX = [(SOFTMAX, "corr[0] = corr[1] = 1.f;", 2)]
NO_PV = [(PV, "      (void)kk;\n", 1)]
PRODUCER = [
    ("__launch_bounds__(128 * WGS, 1)",
     "__launch_bounds__(128 * WGS + 128, 3 - WGS)", 1),
    ("flash_fwd_wgmma<HD, WGS><<<grid, 128 * WGS, BYTES, stream>>>",
     "flash_fwd_wgmma<HD, WGS><<<grid, 128 * WGS + 128, BYTES, stream>>>", 1),
    ("  const bool loader = threadIdx.x == 0;",
     "  const bool loader = threadIdx.x == THREADS;", 1),
    ("""    if (!loader) return;
    if (j + 2 < n_tiles) load_k(j + 2);
    if (j + 1 < n_tiles) load_v(j + 1);
""", "    (void)j;\n", 1),
    ("""  __syncthreads();

  // warpgroup wg owns rows""",
     """  __syncthreads();
  if (threadIdx.x >= THREADS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (loader)
      for (int j = 2; j <= n_tiles; ++j) {
        if (j < n_tiles) load_k(j);
        load_v(j - 1);
      }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
                   WGS == 2 ? 240 : 232) : "memory");

  // warpgroup wg owns rows""", 1),
]
VARIANTS = {
    "full": [],
    "rows64": [(RULE, "  return 64;", 1)],
    "rows128": [(RULE, "  return 128;", 1)],
    "no_mask": [(SOFTMAX, "softmax(sc, m, l, corr, kv0, false);", 2)],
    "no_softmax": NO_SOFTMAX,
    "no_pv": NO_PV,
    "s_only": NO_SOFTMAX + NO_PV,
    "no_loop": [(NTILES, "  const int n_tiles = 0 * (kv_hi + tile_lo);", 1)],
    "producer": PRODUCER,
    "producer4": PRODUCER + [("constexpr int STAGES = 3;",
                              "constexpr int STAGES = 4;", 1)],
    "qfast": [("""  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h % K;""",
               """  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, kh = h % K;""", 1),
              ("  dim3 grid(B * H, (Sq + BQ - 1) / BQ);",
               "  dim3 grid((Sq + BQ - 1) / BQ, H, B);", 1)],
}
# variants whose output must equal the kernel's bits
EXACT = ("full", "rows64", "rows128", "producer", "producer4", "qfast")
OPCODES = ("HGMMA", "MUFU.EX2", "FMNMX", "FMUL", "FFMA", "FADD", "F2FP",
           "FSEL", "SHFL", "SYNCS", "BAR", "WARPGROUP")


def patched(src: str, patches) -> str:
    for old, new, count in patches:
        if src.count(old) != count:
            raise RuntimeError(f"patch expects {count} of {old!r}, found "
                               f"{src.count(old)}")
        src = src.replace(old, new)
    return src


def build_variants(build) -> dict:
    """{variant: library path} of the variants that built; prints
    ptxas' report of the wgmma instances."""
    csrc = build.CSRC
    src = (csrc / "flash_attention.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    procs = {}
    for name, patches in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "flash_attention.cu").write_text(patched(src, patches))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(d / "libflash_attention.so"),
               str(d / "flash_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:    # reported, and left out of the timing
            print(f"[build] variant {name} failed:\n{out[-3000:]}")
            continue
        fn = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            elif fn and "flash_fwd_wgmma" in fn and (
                    "registers" in line or "spill" in line
                    or "setmaxnreg" in line):
                print(f"[ptxas] {name} {demangle(fn)}: {line.strip()}")
            elif "warning" in line:
                print(f"[ptxas] {name}: {line.strip()}")
        libs[name] = OUT / name / "libflash_attention.so"
    return libs


def demangle(sym: str) -> str:
    m = re.search(r"flash_fwd_wgmmaILi(\d+)ELi(\d+)E", sym)
    return f"flash_fwd_wgmma<{m.group(1)}, {m.group(2)}>" if m else sym


def sass_counts(lib: Path) -> None:
    """Static SASS instruction counts of the wgmma instances."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"[sass] cuobjdump did not run: {e}")
        return
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "flash_fwd_wgmma" not in name:
            continue
        ops = Counter()
        for line in part.splitlines():
            m = re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
            if m:
                op = m.group(1)
                for want in OPCODES:
                    if op.startswith(want):
                        ops[want] += 1
                ops["all"] += 1
        print(f"[sass] {demangle(name)}: {dict(ops)}")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    print(chip_smoke.card_line(), flush=True)
    libs = build_variants(build)
    if "full" not in libs:
        return 1
    sass_counts(libs["full"])
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.flash_attention_fwd.argtypes, lib.flash_attention_fwd.restype = (
            fa._SIG)
        fns[name] = lib.flash_attention_fwd

    def call(fn, q, k, v, causal):
        B, Sq, H, hd = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((B, Sq, H), dtype=torch.float32, device="cuda")
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, Sq, k.shape[1], H, k.shape[2], hd,
                hd ** -0.5, 0.0, int(causal), 0, 0, build.current_stream(q))
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return o, lse

    timer = chip_smoke.Timer(torch)

    def timed(fn) -> dict:
        d = {"ms": timer(fn)}
        for _ in range(3):      # the profiler now and then records nothing
            d["device_ms"] = timer.device(fn)
            if d["device_ms"] > 0:
                break
        return d

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {name: {} for name in ["sdpa", *fns]}
    for shape, (B, Sq, Skv, H, K, hd, causal) in SHAPES.items():
        q = torch.randn((B, Sq, H, hd), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((B, Skv, K, hd), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        want = fa.flash_attention(q, k, v, causal=causal)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        res["sdpa"][shape] = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=H != K))
        for name, fn in fns.items():
            try:
                got = call(fn, q, k, v, causal)
            except RuntimeError as e:   # producer4 at hd 128: no room
                res[name][shape] = {"error": str(e)}
                continue
            d = timed(lambda fn=fn: call(fn, q, k, v, causal))
            if name in EXACT:
                d["bit_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(got, want))
                if not d["bit_equal"]:
                    print(f"flash_profile: {name} differs from the kernel "
                          f"at {shape}", file=sys.stderr)
                    return 1
            res[name][shape] = d
        del q, k, v, qt, kt, vt
    for name, d in res.items():
        print(json.dumps({"variant": name, **d}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
