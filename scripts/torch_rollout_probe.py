#!/usr/bin/env python3
"""Where B8, the merged-gate bf16 decode rollout (``csrc/gru_rollout_merged.cu``),
spends a block-step: copies of its source with ``clock64()`` stamps or a part
switched off by text substitution, built beside the source as it is (and,
with ``--parent``, another checkout's B8, e.g. the parent commit's) and called
in one process on one card.

    git archive <parent> skeletondiffusion_tpu_torch/csrc | tar -x -C output/parent
    python3 scripts/torch_rollout_probe.py [--parent output/parent]

The inputs are the rollout's tensors as ``decode_rollout`` hands them to
the kernel, 12 800 rows × 120 steps, from ``chip_smoke.py``'s flagship
decoder (its influences moved off their init; the default, the inputs
chip_smoke holds B8 on) or with ``--inputs decode_check`` from the decode
check's model (``scripts/torch_decode_bf16_check.py``).  Variants of this
tree's B8 (``--variants``, comma-separated; ``a+b`` applies both patches):

* ``base``      the source as it is;
* ``timers``    thread 0 of every fourth block adds the cycles since its last
                stamp at each of the kernel's ``ROLLOUT_STAMP`` points: the
                products' wait for a ring stage and their work on it, the
                mixes (with their wait for the slice's cx), the gate update,
                the hw3 stores, the barrier that ends a slice's pass, the head
                and G update, the head's mix and stores (cycles a
                block-step);
* ``noload``    the producer completes each stage without copying (no ring
                traffic; the products multiply whatever the stage holds);
* ``nomma``     the products load their operands but issue no mma;
* ``accurate``  the sigmoids as 1/(1 + expf(−x)) with an IEEE division (the
                plain versions' function; tanh is tanhf already);
* ``fasttanh``  the n gate's tanh as 1 − 2/(e^{2x} + 1), the fp32 rollout's;
* ``exactexp``  the sigmoids' e^−x as expf (to ~1 ulp; the source has
                __expf, ex2.approx of −x·log2 e);
* ``gate1``     the gate update's three tiles of a slice after one ring stage
                (not spread over three);
* ``nobias``    the products start from zero instead of b_hh (no loads of
                b_hh: what its loads at each slice's start cost);
* ``prefetch``  each slice's b_hh prefetched into L1 during the slice before;
* ``intround``  r and z rounded to bf16 by integer operations (round to
                nearest even on the bits: the same values, no conversion);
* ``noact``     no activations: r = z = the sums, n = its sum (what the
                sigmoids and tanh cost);
* ``spin``      the producer and the cx loader poll their barriers without
                sleeping;
* ``cluster4``  clusters of four blocks (each weight byte from L2 serves 32
                rows; fewer of the card's SMs fit whole clusters).

With ``--parent`` (a checkout whose B8 is the first port's:
``gru_rollout_bf16`` taking W_hh unpacked and no plan): ``parent`` (that
B8 as it is) and ``parent_timers`` (stamps of thread 0 of every fourth block
after its hidden product, its gate update and its output head: cycles a
block-step).  Each variant is timed
(CUDA events, 2 calls a reading, 3 rounds in alternating order) and held
against ``gru_rollout_merged_plain`` on the same inputs: max |Δ| and the mean
|Δ| over the plain version's own mean deviation from the fp32 plain rollout
(chip_smoke's ``B8_MEAN_SHARE`` bound is 0.1).  Prints the card's name, power
limit and SM clock, then one JSON line.  Needs one CUDA device.
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
sys.path.insert(0, str(REPO / "scripts"))

from skeletondiffusion_tpu_torch.ops.kernels import build  # noqa: E402
from skeletondiffusion_tpu_torch.ops.kernels import gru_rollout as rollout  # noqa: E402
import torch_decode_bf16_check as decode_check  # noqa: E402

OUT = REPO / "build" / "rollout_probe"
SRC = "gru_rollout_merged.cu"
VARIANTS = ("base", "timers", "noload", "nomma", "accurate", "fasttanh", "exactexp", "gate1",
            "nobias", "prefetch", "intround", "noact", "spin", "cluster4")
PHASES = ("step_start", "stage_gap", "ring_wait", "product_work", "mix", "gate_update",
          "hw3_store", "slice_sync", "head_and_g", "head_mix_and_store")
PARENT_PHASES = ("hidden_product", "gate_update", "head_and_g")
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
    """A copy of this tree's csrc/ with B8 patched as ``name`` says."""
    dst = OUT / "src" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, dst)
    c = (dst / SRC).read_text()
    for patch in name.split("+"):
        c = patched(c, patch)
    (dst / SRC).write_text(c)
    return dst


def patched(c: str, name: str) -> str:
    """B8's source ``c`` with the patch ``name``."""
    if name == "timers":
        c = sub(c, "#define ROLLOUT_STAMP(k)\n", PROBE + (
            "#define ROLLOUT_STAMP(k) do { if (threadIdx.x == 0 && blockIdx.x % 4 == 0) { "
            "const long long pt_ = clock64(); PROBE_ADD(k, pt_ - probe_prev); probe_prev = pt_; "
            "} } while (0)\n"))
        c = sub(c, "    regs_inc<kConsumerRegs>();\n",
                "    regs_inc<kConsumerRegs>();\n    long long probe_prev = clock64();\n")
        c += PROBE_ENTRY
    elif name == "noload":
        c = sub(c, "        sm90mix::mbar_expect_tx(&b.full[b.q.s], kStageBytes);\n"
                   "        sm90mix::bulk_load_multicast(",
                "        sm90mix::mbar_arrive(&b.full[b.q.s]);\n        if (false) "
                "sm90mix::bulk_load_multicast(")
    elif name == "nomma":
        c = sub(c, "sm90mix::mma_bf16(acc[i][a], wa, bh[i][ks][0], bh[i][ks][1]);", "")
    elif name == "accurate":
        c = sub(c, SIGMOID, "__device__ __forceinline__ float sigmoid(float x) { "
                "return 1.0f / (1.0f + expf(-x)); }")
    elif name == "fasttanh":
        c = sub(c, "  return tanhf(x);\n",
                "  return 1.0f - __fdividef(2.0f, expf(2.0f * x) + 1.0f);\n")
    elif name == "exactexp":
        c = sub(c, SIGMOID, SIGMOID.replace("__expf(-x)", "expf(-x)"))
    elif name == "gate1":
        c = sub(c, "constexpr int kGateStages = 3; ", "constexpr int kGateStages = 1; ")
    elif name == "nobias":
        c = sub(c, "                const float lo = i < nodes ? __ldg(b) : 0.0f;\n"
                   "                const float hi = i < nodes ? __ldg(b + 8) : 0.0f;\n",
                "                const float lo = 0.0f * (b != nullptr), hi = lo;\n")
    elif name == "prefetch":
        c = sub(c, "              ring.release_stage();\n              ROLLOUT_STAMP(3);\n",
                "              ring.release_stage();\n"
                "              if (ks == 3 && J + 1 < kSlices) {\n"
                "#pragma unroll\n"
                "                for (int i = 0; i < 3; ++i)\n"
                "#pragma unroll\n"
                "                  for (int a = 0; a < 3; ++a)\n"
                "                    if (i < nodes) asm volatile(\"prefetch.global.L1 [%0];\" :: "
                "\"l\"(b_hh + (warp + 8 * i) * 3 * kH + a * kH + (J + 1) * kSlice + g));\n"
                "              }\n"
                "              ROLLOUT_STAMP(3);\n")
    elif name == "intround":
        c = sub(c, ROUND_BODY, "  const uint32_t u = __float_as_uint(v);\n"
                "  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);\n")
    elif name == "noact":
        c = sub(c, "                  const float rg = bf16_round(sigmoid(yr[nt][e]));\n"
                   "                  const float zg = bf16_round(sigmoid(yz[nt][e]));\n"
                   "                  const float ng = tanh_gate(yx[nt][e] + rg * yh[nt][e]);\n",
                "                  const float rg = yr[nt][e], zg = yz[nt][e];\n"
                "                  const float ng = yx[nt][e] + rg * yh[nt][e];\n")
    elif name == "spin":
        c = sub(c, "    if (i > 150000000ll) __trap();\n    __nanosleep(64);\n",
                "    if (i > 4000000000ll) __trap();\n")
    elif name == "cluster4":
        c = sub(c, "constexpr int kCluster = 2; ", "constexpr int kCluster = 4; ")
    elif name != "base":
        raise SystemExit(f"unknown variant {name}")
    return c


ROUND_BODY = "  return __bfloat162float(__float2bfloat16_rn(v));\n"
SIGMOID = ("__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.0f, "
           "1.0f + __expf(-x)); }")


def parent_sources(parent: pathlib.Path, name: str) -> pathlib.Path:
    """A copy of the other tree's csrc/, its B8 with stamps for ``parent_timers``."""
    dst = OUT / "src" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(parent / "skeletondiffusion_tpu_torch" / "csrc", dst)
    if name == "parent_timers":
        c = (dst / SRC).read_text()
        stamp = lambda k: (  # noqa: E731
            f"    if (tid == 0 && blockIdx.x % 4 == 0) {{ const long long pt_ = "
            f"clock64(); PROBE_ADD({k}, pt_ - probe_prev); probe_prev = pt_; }}\n")
        c = sub(c, "#include <cstddef>\n", "#include <cstddef>\n" + PROBE)
        c = sub(c, "  for (int t = 0; t < ph; ++t) {\n"
                   "    hidden_product<N, H>(w_hh, b_hh, hb_s, hw_s, scratch);\n"
                   "    __syncthreads();\n"
                   "    gate_update<N, H>(cx, batch, row0, gc_s, hw_s, h_s, hb_s);\n"
                   "    __syncthreads();\n",
                "  long long probe_prev = clock64();\n"
                "  for (int t = 0; t < ph; ++t) {\n"
                "    hidden_product<N, H>(w_hh, b_hh, hb_s, hw_s, scratch);\n"
                "    __syncthreads();\n" + stamp(0) +
                "    gate_update<N, H>(cx, batch, row0, gc_s, hw_s, h_s, hb_s);\n"
                "    __syncthreads();\n" + stamp(1))
        c = sub(c, "    // the next writes of q_s, g_s and gc_s come after the next step's "
                   "barriers\n",
                "    __syncthreads();\n" + stamp(2))
        c += PROBE_ENTRY
        (dst / SRC).write_text(c)
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


def cuda_ms(fn, reps: int = 2) -> float:
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
    """{counter: (sum, count)} of one call of ``run``."""
    buf = (ctypes.c_ulonglong * 32)()
    if lib.probe_reset() != 0:
        raise RuntimeError("probe_reset failed")
    run()
    if lib.probe_read(ctypes.cast(buf, ctypes.c_void_p)) != 0:
        raise RuntimeError("probe_read failed")
    return {k: (buf[k], buf[16 + k]) for k in range(16) if buf[16 + k]}


def ptxas_lines(log: pathlib.Path) -> list:
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=pathlib.Path, default=None,
                        help="root of another checkout (its skeletondiffusion_tpu_torch/csrc)")
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--inputs", choices=("flagship", "decode_check"), default="flagship")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = tuple(args.variants.split(","))
    jobs = {v: ([variant_sources(v) / SRC], OUT / v) for v in variants}
    parents = ("parent", "parent_timers") if args.parent else ()
    jobs.update({v: ([parent_sources(args.parent.resolve(), v) / SRC], OUT / v) for v in parents})
    dirs = compile_all(jobs)
    libs = {v: ctypes.CDLL(str(dirs[v] / "libgru_rollout_merged.so")) for v in jobs}

    bf = torch.bfloat16
    with torch.no_grad():
        if args.inputs == "flagship":
            import chip_smoke
            _, predictor = chip_smoke.build_model(torch.device("cuda"))
            gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
            inp32, inp = chip_smoke.rollout_inputs(predictor, gen, (None, bf))
        else:
            _, dec, x_last2, z = decode_check.setup()
            inp = rollout.rollout_args(dec, x_last2, z, bf)
            inp32 = rollout.rollout_args(dec, x_last2, z)
        n, b, h = inp["h0"].shape
        f, ph = inp["w_fc"].shape[-1], decode_check.PH
        want = rollout.gru_rollout_merged_plain(**inp, ph=ph)
        own = (want - rollout.gru_rollout_plain(**inp32, ph=ph)).abs().mean().item()
    packed = rollout.pack_rollout_bank_bf16(inp["w_hh"])
    out = torch.empty((ph, n, b, f), dtype=torch.float32, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    plan = tuple(rollout.rollout_bf16_plan(n, h, f))

    def call(v):
        t = dict(inp)
        if v.startswith("parent"):
            ptrs = [x.data_ptr() for x in t.values()] + [out.data_ptr()]
            st = entry(libs[v], "gru_rollout_bf16", 10, 5)(*ptrs, n, b, h, f, ph, stream())
        else:
            t["w_hh"] = packed
            ptrs = [x.data_ptr() for x in t.values()] + [out.data_ptr()]
            p = plan[:3] + ((4,) if "cluster4" in v.split("+") else (plan[3],)) + plan[4:]
            st = entry(libs[v], "gru_rollout_bf16", 10, 10)(*ptrs, n, b, h, f, ph, *p, stream())
        if st != 0:
            raise RuntimeError(f"{v}: cudaError {st}")

    names = (*variants, *parents)
    result = {"inputs": args.inputs,
              "ptxas": {v: ptxas_lines(dirs[v] / "gru_rollout_merged.log")
                        for v in (*variants[:1], *parents[:1])},
              "plain_own_mean_from_fp32": own, "errors": {}, "ms": {v: [] for v in names}}
    for v in names:  # correctness first, each variant once
        call(v)
        torch.cuda.synchronize()
        d = (out - want).abs()
        result["errors"][v] = {"max": d.max().item(), "mean_share": d.mean().item() / own,
                               "finite": bool(torch.isfinite(out).all())}
    for r in range(3):
        for v in (names if r % 2 == 0 else names[::-1]):
            result["ms"][v].append(cuda_ms(lambda: call(v)))
    for v, phases in (("timers", PHASES), ("parent_timers", PARENT_PHASES)):
        if v in libs:
            split = read_probe(libs[v], lambda: call(v))
            steps = split.get(0, (0, 1))[1]  # the first stamp runs once a sampled block-step
            result[v] = {"block_steps": steps,
                         **{name: split[k][0] / steps for k, name in enumerate(phases)
                            if k in split}}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
