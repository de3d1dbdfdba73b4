"""Where the time goes inside the port's two redesigned kernels, on one card.

    python3 kernel_lab.py

Builds the kernel sources as they are and copies of them with one part
changed (text replaced in the source, built beside the real libraries),
and times each on the card:
  * kernel #4 (`ln_dense`, bf16) at the HSA qkv, HSA MLP and SAN qkv
    shapes: as built, without the LayerNorm, without the W loads and
    without the output stores (ablations: wrong results, the cost of the
    part removed), against the library pair F.layer_norm + F.linear; device
    time per call from a CUDA graph of 20 calls;
  * kernel #1 (`bev_pool_pooled`) on the flagship rig, bf16 and fp32: each
    of the op's kernels (CSR starts, long-cell list, pool) from the
    profiler, as built, with the long-cell split off (every cell walked
    by one warp) and with 8 feature rows in flight instead of 4, each
    variant checked against the plain version.
Prints one line per case and the card's name and power limit; details go
to chiprun_out/kernel_lab.json. Needs a card.
"""

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

LN_VARIANTS = {
    "as built": [],
    "without the LayerNorm": [(
        "      layer_norm_rows<BM>(a_tile, wg * 64, s_scale, s_shift, C, eps);", "")],
    "without the W loads": [(
        "        mbar_expect_tx(full, kStageBytes);\n"
        "        tma_load_2d(dst, &tmap_w, n0, kb * kBK, full);\n"
        "        tma_load_2d(dst + kStageBytes / 2, &tmap_w, n0 + 64, kb * kBK, full);",
        "        mbar_arrive(full);")],
    "without the stores": [(
        "      tma_store_2d(&tmap_out, stg, n0, m0 + wg * 64);\n"
        "      tma_store_2d(&tmap_out, stg + kOutBox, n0 + 64, m0 + wg * 64);", "")],
}
POOL_VARIANTS = {
    "as built": [],
    "long-cell split off": [("constexpr int kLongRows = 128;",
                             "constexpr int kLongRows = 1 << 30;")],
    "8 rows in flight": [("constexpr int kRowsInFlight = 4;",
                          "constexpr int kRowsInFlight = 8;")],
}
LN_SHAPES = {"hsa_qkv": (67584, 384, 1152), "hsa_mlp": (67584, 384, 384),
             "san_qkv": (17536, 256, 768)}


def build_variants(native, name, variants):
    """{variant: CDLL} of `name`.cu with each variant's replacements, all
    nvcc processes started together."""
    src = (native.CSRC / f"{name}.cu").read_text()
    out_dir = native.BUILD_DIR / "lab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (variant, repl) in enumerate(variants.items()):
        text = src
        for old, new in repl:
            if old not in text:
                raise RuntimeError(f"{name}.cu no longer holds the text {variant!r} replaces")
            text = text.replace(old, new)
        path, lib = out_dir / f"{name}_{i}.cu", out_dir / f"lib{name}_{i}.so"
        path.write_text(text)
        procs[variant] = (subprocess.Popen(
            [native.nvcc_path(), *native.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for variant, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} ({variant}):\n{log}")
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def use(native, name, lib):
    """Route the wrappers' launches of `name` to `lib` (a built variant)."""
    original = getattr(use, "original", None) or native.load
    use.original = original
    native.load = lambda n: lib if n == name else original(n)
    native.function.cache_clear()


def graph_ms(fn, reps=20):
    """Device time per call of fn: a CUDA graph of `reps` calls, replayed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, n=10):
    """{kernel name: device ms per call} from the profiler over n calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / n for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def ln_dense_lab(native, dev):
    from veon_tpu_torch.ops import fused_ln as fl

    libs = build_variants(native, "ln_dense", LN_VARIANTS)
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for shape, (M, C, N) in LN_SHAPES.items():
        x = (2.0 * torch.randn(M, C, generator=gen, device=dev) + 0.5).to(torch.bfloat16)
        s = 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev)
        sh = 0.1 * torch.randn(C, generator=gen, device=dev)
        w = (torch.randn(C, N, generator=gen, device=dev) / math.sqrt(C)).to(torch.bfloat16)
        b = 0.1 * torch.randn(N, generator=gen, device=dev)
        wt, s16, sh16, b16 = w.t(), s.bfloat16(), sh.bfloat16(), b.bfloat16()
        row = {"library pair": graph_ms(
            lambda: F.linear(F.layer_norm(x, (C,), s16, sh16, 1e-5), wt, b16))}
        for variant, lib in libs.items():
            use(native, "ln_dense", lib)
            row[variant] = graph_ms(lambda: fl.ln_dense(x, s, sh, w, b))
        out[shape] = row
        print(f"ln_dense bf16 {shape} {M}x{C} @ {C}x{N}, device ms per call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    return out


def pool_lab(native, dev):
    from veon_tpu_torch.cli.shapes import example_batch_full
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.geometry.frustum import sensor2keyego_chain
    from veon_tpu_torch.lift.lss import LSSLift, two_hot_depth
    from veon_tpu_torch.ops import bev_pool as bp

    libs = build_variants(native, "bev_pool_pooled", POOL_VARIANTS)
    cfg = presets.veon_b(compute_dtype="bfloat16")
    _, _, metas = example_batch_full(cfg, device=dev)
    N = cfg.data.num_cams
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), 1, N)
    pre = LSSLift.from_config(cfg).precompute_sorted(
        s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0], metas["post_trans"][:, 0],
        metas["bda"])
    nx, ny, nz = cfg.grid.size
    num_cells, C = nx * ny * nz, cfg.propagation.dim
    h, w = cfg.feat_hw
    gen = torch.Generator(device=dev).manual_seed(7)
    feat = torch.randn(1, N, h, w, C, generator=gen, device=dev)
    dist = two_hot_depth(torch.rand(1, N, h, w, generator=gen, device=dev) * 58.0 + 1.5, cfg.grid)
    order, rk = pre["order"], pre["rk_pooled"]
    out = {}
    for dt, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        d, f = dist.to(dt), feat.to(dt)
        vals = bp.presorted_vals(d, f, order)
        plain = bp.bev_pool_pooled_plain(vals, rk, num_cells, 8, torch.float32)
        del vals
        for variant, lib in libs.items():
            use(native, "bev_pool_pooled", lib)
            got = bp.bev_pool_pooled(d, f, order, rk, num_cells, 8)
            err = (got.float() - plain).abs().max().item()
            if err > 0.05 * plain.abs().max().item():
                raise AssertionError(f"bev_pool_pooled {variant} {dname}: off by {err}")
            times = device_ms(lambda: bp.bev_pool_pooled(d, f, order, rk, num_cells, 8))
            out[f"{dname} {variant}"] = dict(times, max_abs_err=err)
            print(f"bev_pool_pooled {dname} {variant}: device ms per call "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                  + f"; max|kernel-plain fp32| {err:.3g}", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("kernel_lab: no CUDA device", file=sys.stderr)
        return 1
    from veon_tpu_torch.ops import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    results = {"nvidia_smi": smi, "ln_dense": ln_dense_lab(native, dev),
               "bev_pool_pooled": pool_lab(native, dev)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_lab.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
