#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cugraph_gnn_tpu_torch``) on one
NVIDIA GPU: builds the kernels, holds each against its plain PyTorch version
at the training path's shapes and times it, then trains sampled GraphSAGE at
the full width of ``bench.py``'s configuration.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. card: nvidia-smi's name and power limit; no CUDA device is an error.
2. build: nvcc on every ``csrc/*.cu`` source, all at once; build seconds and
   ptxas's register / shared-memory lines.
3. kernels: on the synthetic ogbn-products graph (2,449,029 nodes, ~113M
   edges), the fused sampler at hop 0 (10,240 seeds) and hop 1 (112,640
   seeds), k = 10, and the row gather (123,904 ids into the 2,449,029 x 128
   f32 table, to bf16 and to f32), each bit-equal to its plain version on
   the same inputs; then CUDA-event times of kernel, plain version and, where
   one exists, the single PyTorch call that computes the same function, with
   the L2 cache flushed before each launch.
4. small-input agreement: one small graph trained for three f32 steps on the
   card (kernels) and on the CPU (plain versions) from the same weights and
   draws; samples and gathered rows bit-equal, losses within 1e-4.
5. train: 1 warm-up and 3 timed blocks of 10 steps (batch 1024, fanouts
   10/10, hidden 256, 47 classes, bf16 activations, Adam 1e-3); losses must
   be finite and each kernel's launch count must match the path (gather 10,
   sampler 2 per block).  Then one block timed stage by stage.
6. the ``kernels`` summary line, and last the ``ok`` line.

Every JSON line carries the card's name and power limit.
"""

import json
import math
import subprocess
import sys
import time


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from cugraph_gnn_tpu_torch import _build
    from cugraph_gnn_tpu_torch.models.zoo import GraphSAGE
    from cugraph_gnn_tpu_torch.ops.kernels.gather_kernel import (
        gather_rows,
        gather_rows_ref,
    )
    from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import (
        fused_uniform_sample,
        fused_uniform_sample_ref,
    )
    from cugraph_gnn_tpu_torch.sampler.neighbor_sampler import (
        multihop_uniform_batched,
    )
    from cugraph_gnn_tpu_torch import train as T

    # float32 products in full precision on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card ------------------------------------------------------------
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    power_limit = smi.split(",")[-1].strip()
    print(smi)
    print(f"device: {card} (count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")

    def emit(obj):
        print(json.dumps({**obj, "card": card, "power_limit": power_limit}),
              flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(["gather_rows", "uniform_sample"])
    wall = time.perf_counter() - t0
    for name, b in built.items():
        print(f"build {name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "ptxas" in line:
                print(f"  {line.strip()}")
    emit({"phase": "build", "wall_s": wall,
          "seconds": {n: b.seconds for n, b in built.items()}})

    # -- 3. kernels at the training path's shapes --------------------------
    t0 = time.perf_counter()
    graph = T.make_synthetic_products(0, dev)
    torch.cuda.synchronize()
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "nodes": graph.num_nodes, "edges": int(graph.indices.shape[0]),
          "max_degree": graph.max_degree})

    gen = torch.Generator(device=dev).manual_seed(1)
    seeds = torch.randint(0, graph.num_nodes, (T.REPS, T.BATCH), generator=gen,
                          device=dev, dtype=torch.int32)
    seeds[:, ::100] = -1          # padded seeds propagate -1 slots downstream
    k = T.FANOUTS[0]
    u0 = torch.rand((T.REPS * T.BATCH, k), generator=gen, device=dev)
    u1 = torch.rand((T.REPS * T.BATCH * (k + 1), T.FANOUTS[1]), generator=gen,
                    device=dev)
    sample = multihop_uniform_batched(graph.indptr, graph.indices, seeds,
                                      T.FANOUTS, u=[u0, u1], device=dev)
    hop_inputs = [(seeds.reshape(-1), u0), (sample.levels[1].reshape(-1), u1)]
    ids = sample.step(0).input_nodes
    assert ids.shape == (123_904,) and bool((ids < 0).any())

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2

    def cuda_ms(fn, iters=20, warmup=3):
        """Median CUDA-event time of ``fn`` with the L2 flushed before each."""
        for _ in range(warmup):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for a, b in ev:
            flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in ev)[iters // 2]

    hbm = 3.35e12   # H100 SXM HBM3 bytes/s (data sheet)
    kernels = []

    # B: fused sampler, bit equality and timing per hop
    b_rows = []
    for h, (sd, u) in enumerate(hop_inputs):
        kf = u.shape[1]
        got = fused_uniform_sample(graph.indptr, graph.indices, sd, u, kf)
        want = fused_uniform_sample_ref(graph.indptr, graph.indices, sd, u, kf)
        torch.cuda.synchronize()
        for name, g, w in zip(("neighbors", "edge_ids", "num_sampled"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"sampler hop {h} {name} differs from the "
                                     f"plain version")
        valid = sd >= 0
        safe = sd.clamp(min=0).long()
        deg = (graph.indptr[safe + 1] - graph.indptr[safe])[valid]
        nbytes = (4 * sd.numel() + 8 * int(valid.sum())
                  + 4 * kf * int((deg > kf).sum())
                  + 4 * int(deg.clamp(max=kf).sum())
                  + (8 * kf + 4) * sd.numel())
        row = {
            "kernel": "uniform_sample", "hop": h, "seeds": sd.numel(), "k": kf,
            "ms": cuda_ms(lambda: fused_uniform_sample(
                graph.indptr, graph.indices, sd, u, kf)),
            "plain_ms": cuda_ms(lambda: fused_uniform_sample_ref(
                graph.indptr, graph.indices, sd, u, kf), iters=5),
            "library_ms": None, "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3,
            "launches_per_step": 2 / T.REPS, "max_abs_err": 0, "bit_equal": True,
        }
        emit(row)
        b_rows.append(row)

    # A: row gather, bit equality for both output types, timing to bf16
    for out_dtype in (torch.bfloat16, torch.float32):
        got = gather_rows(graph.feats, ids, out_dtype)
        want = gather_rows_ref(graph.feats, ids, out_dtype)
        torch.cuda.synchronize()
        bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(bits), want.view(bits)):
            raise AssertionError(f"row gather to {out_dtype} differs from the "
                                 f"plain version")
    a_err = float((got.float() - want.float()).abs().max())
    f = graph.feats.shape[1]
    uniq = int(torch.unique(ids[ids >= 0]).numel())
    a_bytes = 4 * ids.numel() + 4 * f * uniq + 2 * f * ids.numel()
    a_row = {
        "kernel": "gather_rows", "ids": ids.numel(), "table": list(graph.feats.shape),
        "out_dtype": "bfloat16",
        "ms": cuda_ms(lambda: gather_rows(graph.feats, ids, torch.bfloat16)),
        "plain_ms": cuda_ms(lambda: gather_rows_ref(graph.feats, ids,
                                                    torch.bfloat16)),
        "library_ms": cuda_ms(lambda: torch.index_select(
            graph.feats, 0, ids.clamp(min=0)).to(torch.bfloat16)),
        "bytes": a_bytes, "bound_ms": a_bytes / hbm * 1e3,
        "launches_per_step": 1, "max_abs_err": a_err, "bit_equal": True,
    }
    emit(a_row)

    # -- 4. small input: card against CPU ----------------------------------
    small_cpu = T.make_synthetic_products(3, "cpu", num_nodes=2000, feat_dim=16,
                                          classes=5)
    small_gpu = T.SyntheticGraph(small_cpu.indptr.to(dev), small_cpu.indices.to(dev),
                                 small_cpu.feats.to(dev), small_cpu.labels.to(dev),
                                 small_cpu.max_degree)
    torch.manual_seed(3)
    m_cpu = GraphSAGE(16, 32, 5, device="cpu")
    m_gpu = GraphSAGE(16, 32, 5, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    o_cpu = torch.optim.Adam(m_cpu.parameters(), lr=1e-3)
    o_gpu = torch.optim.Adam(m_gpu.parameters(), lr=1e-3)
    g_cpu = torch.Generator().manual_seed(4)
    sd_small = torch.randint(0, 2000, (3, 64), generator=g_cpu, dtype=torch.int32)
    sd_small[:, ::9] = -1
    us = [torch.rand((3 * 64, 4), generator=g_cpu),
          torch.rand((3 * 64 * 5, 3), generator=g_cpu)]
    s_cpu = multihop_uniform_batched(small_cpu.indptr, small_cpu.indices,
                                     sd_small, (4, 3), u=us, device="cpu")
    s_gpu = multihop_uniform_batched(small_gpu.indptr, small_gpu.indices,
                                     sd_small, (4, 3), u=us, device=dev)
    for a, b in zip(s_cpu.levels, s_gpu.levels):
        assert torch.equal(a, b.cpu()), "small sample differs card vs CPU"
    loss_diff = 0.0
    for i in range(3):
        st_cpu, st_gpu = s_cpu.step(i), s_gpu.step(i)
        x_cpu = T.gather_features(st_cpu, small_cpu.feats, torch.float32)
        x_gpu = T.gather_features(st_gpu, small_gpu.feats, torch.float32)
        assert torch.equal(x_cpu, x_gpu.cpu()), "small gather differs card vs CPU"
        l_cpu = T.train_step(m_cpu, o_cpu, x_cpu, st_cpu, small_cpu.labels)
        l_gpu = T.train_step(m_gpu, o_gpu, x_gpu, st_gpu, small_gpu.labels)
        loss_diff = max(loss_diff, abs(float(l_cpu) - float(l_gpu)))
    if not loss_diff <= 1e-4:
        raise AssertionError(f"small f32 train steps: card vs CPU loss differ "
                             f"by {loss_diff}")
    emit({"phase": "small_input_agreement", "steps": 3,
          "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})

    # -- 5. train path at full width ---------------------------------------
    torch.manual_seed(0)
    model = GraphSAGE(T.FEAT_DIM, T.HIDDEN, T.CLASSES, num_layers=len(T.FANOUTS),
                      dtype=torch.bfloat16, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(2)
    blocks = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_rows.launches = 0
    fused_uniform_sample.launches = 0
    for blk in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, edges = T.train_block(model, opt, graph, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        vals = torch.stack(losses).tolist()
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite loss in block {blk}: {vals}")
        emit({"phase": "train", "block": blk, "warmup": blk == 0,
              "losses": vals, "ms_per_step": dt * 1e3 / T.REPS,
              "sampled_edges": int(edges), "sampled_edges_per_s": int(edges) / dt,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
    launches = {"gather_rows": gather_rows.launches,
                "uniform_sample": fused_uniform_sample.launches}
    want = {"gather_rows": T.REPS * blocks, "uniform_sample": 2 * blocks}
    emit({"phase": "launch_counts", "blocks": blocks, "launches": launches,
          "expected": want})
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

    # one more block, stage by stage (CUDA events; each stage synchronised)
    ev = {}

    def timed(name, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r = fn()
        b.record()
        ev.setdefault(name, []).append((a, b))
        return r

    blk_sample = timed("sample", lambda: T.sample_block(graph, gen))
    for i in range(T.REPS):
        st = blk_sample.step(i)
        x = timed("feature_gather", lambda: T.gather_features(st, graph.feats))
        timed("model", lambda: T.train_step(model, opt, x, st, graph.labels))
    torch.cuda.synchronize()
    stages = {n: sum(a.elapsed_time(b) for a, b in v) / T.REPS for n, v in ev.items()}
    with torch.no_grad():
        logits = model(x, st)
    assert logits.shape == (T.BATCH, T.CLASSES) and bool(torch.isfinite(logits).all())
    emit({"phase": "stages", "ms_per_step": stages})

    # -- 6. summary ---------------------------------------------------------
    kernels.append({
        "name": "gather_rows", "route": "cuda",
        "source": "cugraph_gnn_tpu_torch/csrc/gather_rows.cu",
        "replaces": "cugraph_gnn_tpu/ops/pallas/gather_kernel.py:54",
        "launches": launches["gather_rows"], "max_abs_err": a_err,
        "ms": a_row["ms"], "plain_ms": a_row["plain_ms"],
        "bound_ms": a_row["bound_ms"], "bound_by": "bytes",
        "library_ms": a_row["library_ms"]})
    # the sampler's numbers are one block's two launches (hop 0 + hop 1)
    kernels.append({
        "name": "uniform_sample", "route": "cuda",
        "source": "cugraph_gnn_tpu_torch/csrc/uniform_sample.cu",
        "replaces": "cugraph_gnn_tpu/ops/pallas/sample_kernel.py:64",
        "launches": launches["uniform_sample"], "max_abs_err": 0,
        "ms": sum(r["ms"] for r in b_rows),
        "plain_ms": sum(r["plain_ms"] for r in b_rows),
        "bound_ms": sum(r["bound_ms"] for r in b_rows), "bound_by": "bytes",
        "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
