#!/usr/bin/env python3
"""Where the attention kernels spend their time: B2 (the batch-major
attention core) and L1 (the feature-major core of the attention lab), in
copies of the kernel sources with ``clock64()`` stamps or a part switched off
by text substitution, built beside the sources as they are and called in one
process on one card.

    python3 scripts/torch_attention_probe.py

Each variant is timed (CUDA events, 20 calls a reading, 3 rounds in
alternating order) through its C entry at the bench shapes (21 joints,
8 heads × 32, 12 800 rows, bf16) with the plan the variant needs.  B2
(``csrc/joint_attention.cu``):

* ``base``       the sources as they are;
* ``timers``     stamps around each consumer warp's wait for a stage and its
                 work on it, and the producer's wait for a free stage and the
                 time it takes to start its copies (every fourth block):
                 cycles an item;
* ``nocompute``  the consumers release each stage untouched (loads alone);
* ``noload``     the producer completes each stage without copying (work alone);
* ``nostore``    the bodies keep O in shared memory;
* ``cudacore``   the bf16 body switched to the per-lane CUDA-core one;
* ``w16``        16 consumer warps a block;
* ``r1x2``       one row an item, two blocks an SM;
* ``fastexp``    the softmax's expf as __expf;
* ``ieeediv``    the softmax's quotients as IEEE divisions (the same bits).

L1 (``csrc/attention_core_fm.cu``, its TMA path):

* ``fm_base``        the sources as they are;
* ``fm_timers``      stamps of thread 0 (every fourth block) around its wait
                     for a stage, the transpose, the bodies and the store
                     (O staged for its TMA store, the store issued), each to
                     the barrier that ends it, and the producer's wait for a
                     free stage and its three copies: cycles an item;
* ``fm_nocompute``   the consumers release each stage untouched (loads alone);
* ``fm_noload``      the producer completes each stage without copying;
* ``fm_notranspose`` no transpose (the bodies read the tile as it is);
* ``fm_nobody``      no bodies;
* ``fm_nostore``     no store of O;
* ``fm_cudacore``    the bf16 body switched to the per-lane CUDA-core one (the
                     Pallas kernel's rounding points);
* ``fm_tilemajor``   items in the order (column tile, head): the blocks in
                     flight read all heads of few column tiles;
* ``fm_l2_256``      the loads' tensor map promotes L2 fills to 256 bytes;
* ``fm_w16``         16 consumer warps a block (one body a warp an item).

Prints the card's name, power limit and SM clock, then one JSON line (ms
per variant and round, the timers' cycles, the ``-Xptxas -v`` lines of both
base kernels).  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import threading

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from skeletondiffusion_tpu_torch.ops.kernels import (  # noqa: E402
    attention_core_fm, build, joint_attention)

N, H, DH, B = 21, 8, 32, 12800
OUT = REPO / "build" / "attention_probe"
VARIANTS = ("base", "timers", "nocompute", "noload", "nostore", "cudacore", "w16", "r1x2",
            "fastexp", "ieeediv")
FM_VARIANTS = ("fm_base", "fm_timers", "fm_nocompute", "fm_noload", "fm_notranspose",
               "fm_nobody", "fm_nostore", "fm_cudacore", "fm_tilemajor", "fm_l2_256", "fm_w16")
PROBE = r'''
__device__ unsigned long long probe_acc[16];
__device__ unsigned long long probe_cnt[16];
#define PROBE_ADD(k, v) do { atomicAdd(&probe_acc[k], (unsigned long long)(v)); \
                             atomicAdd(&probe_cnt[k], 1ull); } while (0)
'''
PROBE_ENTRY = r'''
extern "C" int probe_read(void* host) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(host, probe_acc, sizeof(probe_acc));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol((char*)host + sizeof(probe_acc), probe_cnt, sizeof(probe_cnt));
}
extern "C" int probe_reset() {
  unsigned long long z[16] = {0};
  cudaError_t e = cudaMemcpyToSymbol(probe_acc, z, sizeof(z));
  return (int)(e == cudaSuccess ? cudaMemcpyToSymbol(probe_cnt, z, sizeof(z)) : e);
}
'''


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{old!r} found {text.count(old)} times")
    return text.replace(old, new)


def variant_sources(name: str) -> pathlib.Path:
    """A copy of this tree's csrc/ with B2 patched as ``name`` says."""
    dst = OUT / "src" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, dst)
    c = (dst / "joint_attention.cu").read_text()
    h = (dst / "joint_attention.cuh").read_text()
    c = sub(c, '#include "joint_attention.cuh"\n', '#include "joint_attention.cuh"\n' + PROBE)
    c += PROBE_ENTRY
    if name == "timers":
        c = sub(c, "      mbar_wait(&full[q.s], q.phase);\n",
                "      const long long ta = clock64();\n      mbar_wait(&full[q.s], q.phase);\n"
                "      const long long tb = clock64();\n")
        c = sub(c, "      fence_proxy_async();  // the stage",
                "      if (lane == 0 && blockIdx.x % 4 == 0) {\n"
                "        PROBE_ADD(0, tb - ta);\n        PROBE_ADD(1, clock64() - tb);\n      }\n"
                "      fence_proxy_async();  // the stage")
        c = sub(c, "        mbar_wait(&empty[q.s], q.phase ^ 1u);  // every consumer warp is done "
                   "with the stage\n",
                "        const long long ta = clock64();\n        mbar_wait(&empty[q.s], q.phase ^ 1u);\n"
                "        const long long tb = clock64();\n")
        c = sub(c, "              bulk_load(dst + i * part, src + i * hd + grp * gw, part, "
                   "&full[q.s]);\n          }\n        }\n",
                "              bulk_load(dst + i * part, src + i * hd + grp * gw, part, "
                "&full[q.s]);\n          }\n        }\n"
                "        if (blockIdx.x % 4 == 0) {\n          PROBE_ADD(2, tb - ta);\n"
                "          PROBE_ADD(3, clock64() - tb);\n        }\n")
    elif name == "nocompute":
        c = sub(c, "task < valid * group_heads;", "task < 0;")
    elif name == "noload":
        c = sub(c, "        mbar_expect_tx(&full[q.s], kNodes * valid * 3 * part);\n"
                   "        for (int n = 0; n < kNodes; ++n) {",
                "        mbar_arrive(&full[q.s]);\n        for (int n = 0; n < 0; ++n) {")
    elif name == "nostore":
        h = sub(h, "  for (int c = threadIdx.x & 31; c < kParts * N; c += 32) {",
                "  for (int c = threadIdx.x & 31; c < 0; c += 32) {")
    elif name == "cudacore":
        h = sub(h, "constexpr bool kTensorCoreBody = std::is_same_v<T, bf16>;",
                "constexpr bool kTensorCoreBody = false;")
    elif name == "w16":
        c = (c.replace("sm90mix::kThreads", "544").replace("kConsumerWarps", "16")
             .replace("kThreads", "544"))
    elif name == "r1x2":
        c = sub(c, "__launch_bounds__(sm90mix::kThreads, 1)", "__launch_bounds__(sm90mix::kThreads, 2)")
    elif name == "fastexp":
        h = sub(h, "          x = expf(x - mx);", "          x = __expf(x - mx);")
    elif name == "ieeediv":
        h = sub(h, "          x = sm90mix::quotient(x, sum, rcp);", "          x = x / sum;")
    (dst / "joint_attention.cu").write_text(c)
    (dst / "joint_attention.cuh").write_text(h)
    return dst


def fm_variant_sources(name: str) -> pathlib.Path:
    """A copy of this tree's csrc/ with L1 patched as ``name`` says."""
    dst = OUT / "src" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, dst)
    c = (dst / "attention_core_fm.cu").read_text()
    h = (dst / "joint_attention.cuh").read_text()
    c = sub(c, '#include "joint_attention.cuh"\n', '#include "joint_attention.cuh"\n' + PROBE)
    c += PROBE_ENTRY
    transpose = ("      transpose_stage<T, C>(smem + 128 + static_cast<size_t>(q.s) * "
                 "l.stage_bytes, tt, cs, ld);\n")
    bodies = "      for (int col = warp; col < valid; col += kWarps) {"
    store = ("        stage_o<T, C>(tt, os, cs, ld);\n",
             "        if (threadIdx.x == 0) tma_store_3d(&out_map, os, b0, h * kDimHead, 0);\n")
    if name == "fm_timers":
        stamp = lambda k: (f"      if (threadIdx.x == 0 && blockIdx.x % 4 == 0) "  # noqa: E731
                           f"{{ const long long t = clock64(); PROBE_ADD({k}, t - pt); pt = t; }}\n")
        c = sub(c, "      mbar_wait(&full[q.s], q.phase);\n",
                "      long long pt = clock64();\n      mbar_wait(&full[q.s], q.phase);\n"
                + stamp(0))
        c = sub(c, "      if (lane == 0) mbar_arrive(&empty[q.s]);  // the stage may be refilled\n",
                "      if (lane == 0) mbar_arrive(&empty[q.s]);  // the stage may be refilled\n"
                + stamp(1))
        c = sub(c, "      if (tma) {\n        if (threadIdx.x == 0) tma_store_wait<true>();",
                stamp(2) + "      if (tma) {\n        if (threadIdx.x == 0) tma_store_wait<true>();")
        c = sub(c, store[1], store[1] + "  " + stamp(3))
        c = sub(c, "          mbar_wait(&empty[q.s], q.phase ^ 1u);  // every consumer warp has read "
                   "the stage\n",
                "          const long long ta = clock64();\n"
                "          mbar_wait(&empty[q.s], q.phase ^ 1u);\n"
                "          const long long tb = clock64();\n")
        c = sub(c, "            tma_load_3d(st + part * l.part, &in_map, b0, part * hd + h * kDimHead, "
                   "0, &full[q.s]);\n",
                "            tma_load_3d(st + part * l.part, &in_map, b0, part * hd + h * kDimHead, "
                "0, &full[q.s]);\n          if (blockIdx.x % 4 == 0) {\n"
                "            PROBE_ADD(4, tb - ta);\n            PROBE_ADD(5, clock64() - tb);\n"
                "          }\n")
    elif name == "fm_nocompute":
        c = sub(c, transpose, "")
        c = sub(c, bodies, "      for (int col = warp; col < 0; col += kWarps) {")
        c = sub(sub(c, store[0], ""), store[1], "")
    elif name == "fm_noload":
        c = sub(c, "          mbar_expect_tx(&full[q.s], static_cast<uint32_t>(l.stage_bytes));\n"
                   "          for (int part = 0; part < 3; ++part)\n",
                "          mbar_arrive(&full[q.s]);\n          for (int part = 0; part < 0; ++part)\n")
    elif name == "fm_notranspose":
        c = sub(c, transpose, "")
    elif name == "fm_nobody":
        c = sub(c, bodies, "      for (int col = warp; col < 0; col += kWarps) {")
    elif name == "fm_nostore":
        c = sub(sub(c, store[0], ""), store[1], "")
    elif name == "fm_tilemajor":
        c = sub(c, "  b0 = item % tiles * cols;\n  h = item / tiles;\n",
                "  b0 = item / heads * cols;\n  h = item % heads + 0 * tiles;\n")
    elif name == "fm_w16":
        c = sub(c, "constexpr int kWarps = 8;", "constexpr int kWarps = 16;")
    elif name == "fm_l2_256":
        c = sub(c, "CU_TENSOR_MAP_L2_PROMOTION_L2_128B", "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")
    elif name == "fm_cudacore":
        h = sub(h, "constexpr bool kTensorCoreBody = std::is_same_v<T, bf16>;",
                "constexpr bool kTensorCoreBody = false;")
    (dst / "attention_core_fm.cu").write_text(c)
    (dst / "joint_attention.cuh").write_text(h)
    return dst


def compile_all(jobs: dict) -> dict:
    """{name: (sources, out_dir)} built at once → {name: out_dir}."""
    errors = []

    def one(name, srcs, out):
        try:
            build.compile_sources(srcs, out)
        except RuntimeError as e:
            errors.append(f"{name}: {str(e)[-4000:]}")

    threads = [threading.Thread(target=one, args=(k, *v)) for k, v in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return {k: v[1] for k, v in jobs.items()}


def entry(lib, symbol, n_pointers, n_ints):
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def read_probe(lib, run) -> dict:
    """{counter: (mean, count)} of one call of ``run``."""
    buf = (ctypes.c_ulonglong * 32)()
    if lib.probe_reset() != 0:
        raise RuntimeError("probe_reset failed")
    run()
    if lib.probe_read(ctypes.cast(buf, ctypes.c_void_p)) != 0:
        raise RuntimeError("probe_read failed")
    return {k: (buf[k] / buf[16 + k], buf[16 + k]) for k in range(16) if buf[16 + k]}


def ptxas_lines(log: pathlib.Path, kernels: tuple) -> list:
    lines, fn = [], None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            try:
                fn = subprocess.run(["/usr/local/cuda/bin/cu++filt", fn], capture_output=True,
                                    text=True, timeout=60).stdout.strip()
            except OSError:
                pass
        if fn and any(k in fn for k in kernels) and ("registers" in ln or "spill" in ln):
            lines.append(f"{fn[:100]} :: {ln.strip()}")
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    jobs = {v: ([variant_sources(v) / "joint_attention.cu"], OUT / v) for v in VARIANTS}
    jobs.update({v: ([fm_variant_sources(v) / "attention_core_fm.cu"], OUT / v)
                 for v in FM_VARIANTS})
    dirs = compile_all(jobs)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    qkv = torch.randn((N, B, 3 * H * DH), generator=gen, device="cuda").to(bf)
    out = torch.empty((N, B, H * DH), dtype=bf, device="cuda")
    qkv_fm = qkv.permute(0, 2, 1).contiguous()
    out_fm = torch.empty((N, H * DH, B), dtype=bf, device="cuda")
    plan = tuple(joint_attention.attention_plan(bf, H, DH))
    plans = {v: plan for v in VARIANTS}
    plans["r1x2"] = (1, H, 3, joint_attention.plan_bytes(2, 1, H, DH, 3))
    fm_plan = tuple(attention_core_fm.fm_plan(bf, H, DH))
    libs = {v: ctypes.CDLL(str(dirs[v] / "libjoint_attention.so")) for v in VARIANTS}
    libs.update({v: ctypes.CDLL(str(dirs[v] / "libattention_core_fm.so")) for v in FM_VARIANTS})

    def call(v):
        if v.startswith("fm_"):
            st = entry(libs[v], "attention_core_fm_bf16", 2, 7)(
                qkv_fm.data_ptr(), out_fm.data_ptr(), N, B, H, DH, *fm_plan, stream())
        else:
            st = entry(libs[v], "attention_core_bf16", 2, 9)(qkv.data_ptr(), out.data_ptr(), N,
                                                              B, H, DH, DH, *plans[v], stream())
        if st != 0:
            raise RuntimeError(f"{v}: cudaError {st}")

    result = {"ptxas_base": ptxas_lines(dirs["base"] / "joint_attention.log",
                                        ("attention_core",))
              + ptxas_lines(dirs["fm_base"] / "attention_core_fm.log", ("attention_core_fm",)),
              "ms": {v: [] for v in (*VARIANTS, *FM_VARIANTS)}}
    for r in range(3):
        for v in ((*VARIANTS, *FM_VARIANTS) if r % 2 == 0 else (*VARIANTS, *FM_VARIANTS)[::-1]):
            result["ms"][v].append(cuda_ms(lambda: call(v)))
    split = read_probe(libs["timers"], lambda: call("timers"))
    result["timers"] = {name: split.get(k) for k, name in enumerate(
        ("consumer_wait_full", "consumer_work", "producer_wait_empty", "producer_copies"))}
    split = read_probe(libs["fm_timers"], lambda: call("fm_timers"))
    result["fm_timers"] = {name: split.get(k) for k, name in enumerate(
        ("consumer_wait_full", "transpose", "bodies", "store", "producer_wait_empty",
         "producer_copies"))}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
