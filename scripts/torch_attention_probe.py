#!/usr/bin/env python3
"""Where B2 (the attention core) spends its time, and, for the sources
before its redesign, where B2 and B9a (the layer-fused stem + block 0) spent
theirs: copies of the kernel sources with ``clock64()`` stamps or a part
switched off by text substitution, built beside the sources as they are and
called in one process on one card.

    git archive <parent> skeletondiffusion_tpu_torch/csrc | tar -x -C output/parent
    python3 scripts/torch_attention_probe.py [--parent output/parent]

This tree's B2 (``csrc/joint_attention.cu``) in variants, each timed (CUDA
events, 20 calls a reading, 3 rounds in alternating order) through its C
entry at the bench shapes (21 joints, 8 heads × 32, 12 800 rows, bf16) with
the plan the variant needs:

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

With ``--parent`` (the sources before the redesign), its B2 (a block a row,
a warp a head, a lane a query joint) with stamps between the row's load and
each phase of the body (every eighth block; lane 0 of each warp), and its
B9a (16 rows a block, the wmma products of node_mix.cuh) with thread 0's
stamps between the block's barriers, each beside the unpatched kernel's ms;
and the parent's ``-Xptxas -v`` lines of both.  Prints the card's name,
power limit and SM clock, then one JSON line.  Needs one CUDA device.
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

from skeletondiffusion_tpu_torch.ops.kernels import build, joint_attention  # noqa: E402

N, H, DH, B, D, F = 21, 8, 32, 12800, 96, 192
OUT = REPO / "build" / "attention_probe"
VARIANTS = ("base", "timers", "nocompute", "noload", "nostore", "cudacore", "w16", "r1x2",
            "fastexp", "ieeediv")
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
        h = sub(h, "  for (int c = lane; c < 4 * N; c += 32) {", "  for (int c = lane; c < 0; c += 32) {")
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


def parent_sources(parent: pathlib.Path) -> pathlib.Path:
    """A copy of the parent's csrc/ with stamps in B2 and B9a."""
    dst = OUT / "src" / "parent_probe"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(parent / "skeletondiffusion_tpu_torch" / "csrc", dst)
    h = (dst / "joint_attention.cuh").read_text()
    mark = lambda k: (f"  {{ long long t = clock64(); if (probe) PROBE_ADD({k}, t - pt); "  # noqa
                      f"pt = t; }}\n")
    h = sub(h, "  if (n >= N) return;\n  float p[N];\n",
            "  if (n >= N) return;\n  const bool probe = (blockIdx.x % 8 == 0) && n == 0;\n"
            "  long long pt = clock64();\n  float p[N];\n")
    h = sub(h, "  float mx = p[0];\n", mark(1) + "  float mx = p[0];\n")
    h = sub(h, "  float acc[DH];\n", mark(2) + "  float acc[DH];\n")
    h = sub(h, "  T* o = o_base + static_cast<size_t>(n) * ldo;\n",
            mark(3) + "  T* o = o_base + static_cast<size_t>(n) * ldo;\n")
    h = sub(h, "  for (int c = 0; c < DH; c += 8) store8(o + c, acc + c);\n}",
            "  for (int c = 0; c < DH; c += 8) store8(o + c, acc + c);\n" + mark(4) + "}")
    (dst / "joint_attention.cuh").write_text(h)
    c = (dst / "joint_attention.cu").read_text()
    c = sub(c, "  T* s = reinterpret_cast<T*>(smem_raw);\n",
            "  T* s = reinterpret_cast<T*>(smem_raw);\n  const long long t0 = clock64();\n")
    c = sub(c, "  __syncthreads();\n\n  const int h = threadIdx.x >> 5;",
            "  __syncthreads();\n  if (threadIdx.x == 0 && blockIdx.x % 8 == 0) "
            "PROBE_ADD(0, clock64() - t0);\n  const int h = threadIdx.x >> 5;")
    (dst / "joint_attention.cu").write_text(c + PROBE_ENTRY)
    m = (dst / "node_mix.cuh").read_text()
    mark0 = lambda k: (f"  if (threadIdx.x == 0) {{ long long t = clock64(); "  # noqa
                       f"PROBE_ADD({k}, t - pt); pt = t; }}\n")
    m = sub(m, "#pragma once\n", "#pragma once\n" + PROBE)
    m = sub(m, "  T* p = sm.p;\n  node_products(stage_in,",
            "  T* p = sm.p;\n  long long pt = clock64();\n  node_products(stage_in,")
    m = sub(m, "                });\n  node_mix(p, f, f, g1s,",
            "                });\n" + mark0(10) + "  node_mix(p, f, f, g1s,")
    m = sub(m, "  });\n  node_products(\n      [&](int n, T* buf) { stage_from_p(buf, p, f, n, f); },",
            "  });\n" + mark0(11) +
            "  node_products(\n      [&](int n, T* buf) { stage_from_p(buf, p, f, n, f); },")
    m = sub(m, "        p[(n * R + r) * f + c] = from_f<T>(acc + to_f(b2[n * f + c]));\n      });\n",
            "        p[(n * R + r) * f + c] = from_f<T>(acc + to_f(b2[n * f + c]));\n      });\n"
            + mark0(12))
    m = sub(m, "      out[i] = from_f<T>(tanhf(y) + to_f(o_dev[i]));\n    }\n  });\n",
            "      out[i] = from_f<T>(tanhf(y) + to_f(o_dev[i]));\n    }\n  });\n" + mark0(13))
    (dst / "node_mix.cuh").write_text(m)
    lf = (dst / "layer_fused.cu").read_text()
    lf = sub(lf, "  T* p = sm.p;\n  node_products(",
             "  T* p = sm.p;\n  long long pt0 = clock64();\n  node_products(")
    lf = sub(lf, "        p[(n * R + r) * f + c] = from_f<T>(h);\n      });\n",
             "        p[(n * R + r) * f + c] = from_f<T>(h);\n      });\n"
             "  if (threadIdx.x == 0 && sizeof(T) == 2) PROBE_ADD(8, clock64() - pt0);\n")
    lf = sub(lf, "    if (r < valid) r_out[at(n, rows, b0 + r, f, c)] = v;\n  });\n",
             "    if (r < valid) r_out[at(n, rows, b0 + r, f, c)] = v;\n  });\n"
             "  if (threadIdx.x == 0 && sizeof(T) == 2) PROBE_ADD(9, clock64() - pt0);\n")
    (dst / "layer_fused.cu").write_text(lf + PROBE_ENTRY)
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
    parser.add_argument("--parent", type=pathlib.Path, default=None,
                        help="root of the checkout before the redesign")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    jobs = {v: ([variant_sources(v) / "joint_attention.cu"], OUT / v) for v in VARIANTS}
    if args.parent is not None:
        psrc = args.parent.resolve() / "skeletondiffusion_tpu_torch" / "csrc"
        probed = parent_sources(args.parent.resolve())
        jobs["parent"] = ([psrc / "joint_attention.cu", psrc / "layer_fused.cu"], OUT / "parent")
        jobs["parent_probe"] = ([probed / "joint_attention.cu", probed / "layer_fused.cu"],
                                OUT / "parent_probe")
    dirs = compile_all(jobs)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    qkv = torch.randn((N, B, 3 * H * DH), generator=gen, device="cuda").to(bf)
    out = torch.empty((N, B, H * DH), dtype=bf, device="cuda")
    plan = tuple(joint_attention.attention_plan(bf, H, DH))
    plans = {v: plan for v in VARIANTS}
    plans["r1x2"] = (1, H, 3, joint_attention.plan_bytes(2, 1, H, DH, 3))
    libs = {v: ctypes.CDLL(str(dirs[v] / "libjoint_attention.so")) for v in VARIANTS}

    def b2(v):
        st = entry(libs[v], "attention_core_bf16", 2, 8)(qkv.data_ptr(), out.data_ptr(), N, B, H,
                                                          DH, *plans[v], stream())
        if st != 0:
            raise RuntimeError(f"{v}: cudaError {st}")

    result = {"ptxas_base": ptxas_lines(dirs["base"] / "joint_attention.log",
                                        ("attention_core",)),
              "ms": {v: [] for v in VARIANTS}}
    for r in range(3):
        for v in (VARIANTS if r % 2 == 0 else VARIANTS[::-1]):
            result["ms"][v].append(cuda_ms(lambda: b2(v)))
    split = read_probe(libs["timers"], lambda: b2("timers"))
    result["timers"] = {name: split.get(k) for k, name in enumerate(
        ("consumer_wait_full", "consumer_work", "producer_wait_empty", "producer_copies"))}

    if args.parent is not None:
        plib = {v: {n: ctypes.CDLL(str(dirs[v] / f"lib{n}.so"))
                    for n in ("joint_attention", "layer_fused")} for v in ("parent", "parent_probe")}
        rnd = lambda *s, sc=1.0: (sc * torch.randn(s, generator=gen, device="cuda")).to(bf)  # noqa
        gm = lambda: (torch.rand((N, N), generator=gen, device="cuda") * 2 / N).to(bf)  # noqa
        x, u, film = rnd(N, B, D), rnd(N, B, F, sc=0.5), rnd(2 * F, sc=0.1)
        stem = [rnd(N, D, F, sc=D ** -0.5), rnd(N, F, sc=0.1), gm()]
        block = [rnd(N, F, F, sc=F ** -0.5), rnd(N, F, sc=0.1), gm(),
                 rnd(N, F, F, sc=F ** -0.5), rnd(N, F, sc=0.1), gm()]
        r_out, o = torch.empty_like(u), torch.empty_like(u)

        def p_b2(v):
            st = entry(plib[v]["joint_attention"], "attention_core_bf16", 2, 4)(
                qkv.data_ptr(), out.data_ptr(), N, B, H, DH, stream())
            if st != 0:
                raise RuntimeError(f"{v} B2: cudaError {st}")

        def p_b9a(v):
            ptrs = [t.data_ptr() for t in (x, u, film, *stem, *block, r_out, o)]
            st = entry(plib[v]["layer_fused"], "stem_block_bf16", 14, 4)(*ptrs, N, B, D, F,
                                                                          stream())
            if st != 0:
                raise RuntimeError(f"{v} B9a: cudaError {st}")

        ms = {f"{k}_{v}": [] for k in ("b2", "b9a") for v in plib}
        for r in range(2):
            for v in (list(plib) if r % 2 == 0 else list(plib)[::-1]):
                ms[f"b2_{v}"].append(cuda_ms(lambda: p_b2(v)))
                ms[f"b9a_{v}"].append(cuda_ms(lambda: p_b9a(v)))
        b2_split = read_probe(plib["parent_probe"]["joint_attention"], lambda: p_b2("parent_probe"))
        b9a_split = read_probe(plib["parent_probe"]["layer_fused"], lambda: p_b9a("parent_probe"))
        result["parent"] = {
            "ms": ms,
            "ptxas": ptxas_lines(dirs["parent"] / "joint_attention.log", ("attention_core",))
            + ptxas_lines(dirs["parent"] / "layer_fused.log", ("stem_block",)),
            "b2_cycles": {name: b2_split.get(k) for k, name in enumerate(
                ("load_block", "qk_warp", "softmax_warp", "pv_warp", "store_warp"))},
            "b9a_cycles": {name: b9a_split.get(k) for k, name in zip(
                range(8, 14), ("stem_products", "stem_products_mix_store_r", "products_w1",
                               "mix_film", "products_w2", "mix_residual_store"))},
        }
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
