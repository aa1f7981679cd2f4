#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cugraph_gnn_tpu_torch``) on one
NVIDIA GPU: builds the kernels, holds each against its plain PyTorch version
at the training paths' shapes and times it, then trains sampled GraphSAGE at
the full width of ``bench.py``'s configuration, and full-batch GraphSAGE,
GCN and 4-head GAT over a banded graph at ogbn-products scale.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. card: nvidia-smi's name and power limit; no CUDA device is an error.
2. build: nvcc on every ``csrc/*.cu`` source, all at once, and g++ on the
   host graph builders; build seconds and ptxas's register / shared-memory
   lines.
3. kernels: on the synthetic ogbn-products graph (2,449,029 nodes,
   121,124,824 edges, mean degree ~49.5), the fused sampler at hop 0 (10,240
   seeds) and hop 1 (112,640 seeds), k = 10, and the row gather (123,904 ids
   into the 2,449,029 x 128 f32 table, to bf16 and to f32), each bit-equal
   to its plain version on the same inputs; then CUDA-event times of kernel,
   plain version and, where one exists, the single PyTorch call that
   computes the same function, with the L2 cache flushed before each launch.
4. small-input agreement: one small graph trained for three f32 steps on the
   card (kernels) and on the CPU (plain versions) from the same weights and
   draws; samples and gathered rows bit-equal, losses within 1e-4.
5. train: 1 warm-up and 3 timed blocks of 10 steps (batch 1024, fanouts
   10/10, hidden 256, 47 classes, bf16 activations, Adam 1e-3); losses must
   be finite and each kernel's launch count must match the path (gather 10,
   sampler 2 per block).  Then one block timed stage by stage.
6. full-batch data: the banded graph of ``train_full`` (2,449,029 nodes, 12
   in-band sources within +-256 and 1 uniform source per node: 31,837,377
   edges) and its ``FullBatchGraph`` (reorder "none", R = 256) with the
   transpose; host seconds of each build.
7. full-batch kernels: the slab SpMM's band kernel, the CSR SpMM kernel on
   the fallback edges and the two together (``slab_spmm``), over the graph
   and its transpose, on f32 and bf16 x at F = 128 and 256, against the
   float32 sums of their plain versions: within 1e-5 absolute plus 1e-5
   relative to the sum of the terms' magnitudes (the sum order differs, and
   the transpose's hub rows sum hundreds of terms), a bf16 output within one
   bf16 ulp more.  Then
   times at the three calls of one training step (bf16 x: graph F = 128,
   graph F = 256, transpose F = 256) of kernel, plain version and
   ``torch.sparse.mm`` over the same edges, with the byte and operation
   counts that bound them.
8. small-input agreement, full batch: GraphSAGE and GCN each trained for
   three f32 steps on the card and on the CPU from the same weights; losses
   within 1e-4.
9. full-batch train: GraphSAGE, then GCN (F = 128, hidden 256, 47 classes,
   bf16 activations, f32 params, Adam 5e-3), 1 warm-up and 3 timed steps
   each; finite losses, and 3 band-kernel and 3 CSR-kernel launches per step
   (two forward aggregations and one backward: layer 0's input needs no
   gradient).  Then one step timed stage by stage.
10. attention pairs: the graph's (R = 256, bit planes: the band CSR by
    source) and a second ``FullBatchGraph`` of the same graph at R = 512
    (no bit planes: ``t_ell``); host seconds of each.
11. attention kernels at full width: the forward and backward kernels on
    both pairs at GAT's two layers' shapes (H=4, F=64 and H=1, F=47, f32 x)
    plus one bf16-x forward, against their plain versions: within 1e-5
    absolute plus 1e-5 of the same sums over the terms' magnitudes (|x|,
    and for the backward |g| and -|t|: every term's absolute value; the
    kernels sum in another order and factor the dot products out of the
    sums), m equal and s within 1e-5.  Then CUDA-event times of kernel and
    plain version at the main path's calls, with the byte and operation
    counts that bound them (no single PyTorch call computes the fused
    attention: library_ms is null).
12. small-input agreement, GAT: three f32 full-batch steps on the card and
    on the CPU from the same weights; losses within 1e-4.
13. full-batch GAT train (``gat4h``: 4 heads of 64, then 47 classes, f32,
    Adam 5e-3), 1 warm-up and 3 timed steps at R = 256; finite losses and,
    per step, 2 forward attention launches and 2 ``onepass_bwd`` launches
    (layer 0's input ``wx`` needs a gradient: ``lin`` has parameters), no
    other kernel.  Then one step timed stage by stage, and one step at
    R = 512: 2 forward launches, 1 ``slab_attention_bwd`` (layer 1, H = 1)
    and 1 ``slab_attention_bwd_mh`` (layer 0, H = 4).
14. the ``kernels`` summary line, and last the ``ok`` line.

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

H100_F32_OPS = 67e12   # H100 SXM float32 outside the tensor cores (data sheet)


def full_batch(dev, emit, cuda_ms, hbm, counters):
    """Phases 6-9 (see the module docstring).  Returns the ``kernels`` rows
    of the band kernel and the CSR SpMM kernel, and what the GAT phases
    reuse: the graph's COO, its ``FullBatchGraph``, f32 features and
    labels."""
    import torch
    from torch.nn import functional as F

    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.models.zoo import GCN, GraphSAGE
    from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import (
        slab_spmm,
        slab_spmm_band,
        slab_spmm_band_ref,
        slab_spmm_ref,
    )
    from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import csr_spmm, csr_spmm_ref

    # -- 6. full-batch data --------------------------------------------------
    t0 = time.perf_counter()
    g = TF.make_synthetic_banded(0, dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fbg = FullBatchGraph.from_coo(g.src, g.dst, g.num_nodes, reorder="none",
                                  block_rows=TF.BLOCK_ROWS, device=dev)
    torch.cuda.synchronize()
    n, edges = g.num_nodes, g.num_edges
    slabs = {"graph": fbg.slab, "transpose": fbg.slab_t}
    fb_edges = {k: int((s.fb_src >= 0).sum()) for k, s in slabs.items()}
    emit({"phase": "full_batch_data", "nodes": n, "edges": edges,
          "data_s": data_s, "full_batch_graph_s": time.perf_counter() - t0,
          "build_seconds": fbg.build_seconds, "band_fraction": fbg.band_fraction,
          "ell_k": {k: s.ell.shape[1] for k, s in slabs.items()},
          "fallback_edges": fb_edges,
          "max_degree": {k: int(s.degrees.max()) for k, s in slabs.items()},
          "max_fallback_row": {k: int((s.fb_rowptr[1:] - s.fb_rowptr[:-1]).max())
                               for k, s in slabs.items()}})
    if not 0.5 < fbg.band_fraction < 1.0 or not fbg.use_slab:
        raise AssertionError(f"band fraction {fbg.band_fraction}: the slab path "
                             f"and the fallback must both do work")

    # -- 7. full-batch kernels at full width --------------------------------
    def check(name, got, f32_sum, magnitude, what):
        """``got`` against the plain version's float32 sum: within 1e-5,
        absolute and relative to ``magnitude`` (the same sum over the terms'
        absolute values, the scale of sum-order rounding); a bf16 ``got``
        also within one bf16 ulp of the sum.  Returns the max abs
        difference of a float32 ``got`` (None for bf16)."""
        torch.cuda.synchronize()
        tol = 1e-5 * (1 + magnitude)
        if got.dtype == torch.bfloat16:
            _, e = torch.frexp(f32_sum)
            tol = tol + torch.ldexp(torch.ones_like(f32_sum), e - 8)
        diff = (got.float() - f32_sum).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(f"{name} {what}: off its plain version by "
                                 f"{float(diff.max())}")
        return float(diff.max()) if got.dtype == torch.float32 else None

    gen = torch.Generator(device=dev).manual_seed(5)
    xs = {128: g.feats, 256: torch.randn((n, 256), generator=gen, device=dev)}
    errs = {"slab_spmm": 0.0, "csr_spmm": 0.0}
    for orient, slab in slabs.items():
        reduce = "mean" if orient == "graph" else "sum"
        for f, xf in xs.items():
            for dt in (torch.float32, torch.bfloat16):
                x = xf.to(dt)
                ax = x.float().abs()
                what = f"{orient} F={f} {dt}"
                e_band = check("slab_spmm_band", slab_spmm_band(slab, x, torch.float32),
                               slab_spmm_band_ref(slab, x, torch.float32),
                               slab_spmm_band_ref(slab, ax, torch.float32), what)
                e_fb = check("csr_spmm", csr_spmm(slab.fallback, x),
                             csr_spmm_ref(slab.fallback, x.float()),
                             csr_spmm_ref(slab.fallback, ax), what)
                e_all = check("slab_spmm", slab_spmm(slab, x, reduce, torch.float32),
                              slab_spmm_ref(slab, x.float(), reduce, torch.float32),
                              slab_spmm_ref(slab, ax, reduce, torch.float32),
                              f"{what} {reduce}")
                if dt == torch.float32:   # each kernel against its own plain version
                    errs["slab_spmm"] = max(errs["slab_spmm"], e_band)
                    errs["csr_spmm"] = max(errs["csr_spmm"], e_fb)
                emit({"phase": "full_batch_kernel_check", "orientation": orient,
                      "f": f, "dtype": str(dt), "reduce": reduce,
                      "max_abs_err": {"band": e_band, "csr": e_fb, "slab_spmm": e_all},
                      "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum; "
                                   "bf16 outputs one bf16 ulp more"})
                del x, ax
    torch.cuda.empty_cache()

    def band_csr(slab, dtype):
        """The band's edges as a torch CSR matrix (columns sorted in rows)."""
        r_blk = slab.block_rows
        ell = slab.ell[:n].long()
        base = (torch.arange(n, device=dev) // r_blk) * r_blk - r_blk
        big = torch.iinfo(torch.int64).max
        cols = torch.where(ell >= 0, base[:, None] + ell, big).sort(dim=1).values
        crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        crow[1:] = (cols != big).sum(dim=1).cumsum(0)
        cols = cols[cols != big]
        return torch.sparse_csr_tensor(crow, cols, torch.ones_like(cols, dtype=dtype),
                                       (n, n))

    def fallback_csr(slab, dtype):
        ok = slab.fb_src >= 0
        key = (slab.fb_dst[ok].long() * n + slab.fb_src[ok].long()).sort().values
        cols = key % n
        return torch.sparse_csr_tensor(slab.fb_rowptr, cols,
                                       torch.ones_like(cols, dtype=dtype), (n, n))

    def bound(nbytes, ops):
        b_ms, o_ms = nbytes / hbm * 1e3, ops / H100_F32_OPS * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    # the three calls of one training step: layer 0 and layer 1 forward
    # (graph), layer 1's backward (transpose); bf16 activations
    step_calls = [("graph", 128), ("graph", 256), ("transpose", 256)]
    timing = {"slab_spmm": [], "csr_spmm": []}
    for orient, f in step_calls:
        slab = slabs[orient]
        x = xs[f].to(torch.bfloat16)
        el = x.element_size()
        nnz_band = int((slab.ell[:n] >= 0).sum())
        a_band = band_csr(slab, x.dtype)
        band_bytes = slab.ell.numel() * 4 + x.numel() * el + n * f * 4
        b_ms, b_by = bound(band_bytes, nnz_band * f)
        row = {"kernel": "slab_spmm", "orientation": orient, "f": f,
               "dtype": "bfloat16", "band_edges": nnz_band,
               "ms": cuda_ms(lambda: slab_spmm_band(slab, x, torch.float32)),
               "plain_ms": cuda_ms(lambda: slab_spmm_band_ref(slab, x, torch.float32),
                                   iters=5),
               "library_ms": cuda_ms(lambda: torch.sparse.mm(a_band, x)),
               "bytes": band_bytes, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        timing["slab_spmm"].append(row)
        del a_band

        fb = slab.fallback
        nv = fb_edges[orient]
        src = slab.fb_src[:nv]
        uniq = int(torch.unique(src).numel())
        rows_with = int((fb.rowptr[1:] > fb.rowptr[:-1]).sum())
        a_fb = fallback_csr(slab, x.dtype)
        acc = torch.zeros((n, f), dtype=torch.float32, device=dev)
        # accumulate mode, as the path calls it: the row pointer, the valid
        # slots' columns, each distinct source row once, and each output row
        # that has slots read and written once
        fb_bytes = (fb.rowptr.numel() * 8 + nv * 4 + uniq * f * el
                    + 2 * rows_with * f * 4)
        c_ms, c_by = bound(fb_bytes, nv * f)
        row = {"kernel": "csr_spmm", "orientation": orient, "f": f,
               "dtype": "bfloat16", "fallback_edges": nv, "distinct_sources": uniq,
               "rows_with_edges": rows_with,
               "ms": cuda_ms(lambda: csr_spmm(fb, x, out=acc)),
               "plain_ms": cuda_ms(lambda: csr_spmm_ref(fb, x, out=acc), iters=5),
               "library_ms": cuda_ms(lambda: torch.sparse.mm(a_fb, x)),
               "bytes": fb_bytes, "bound_ms": c_ms, "bound_by": c_by}
        emit(row)
        timing["csr_spmm"].append(row)
        del a_fb, acc, x
    del xs
    torch.cuda.empty_cache()

    # -- 8. small input, full batch: card against CPU -----------------------
    small = TF.make_synthetic_banded(3, "cpu", num_nodes=3000, deg=8, band=100,
                                     feat_dim=16, classes=5)
    kw = dict(reorder="none", block_rows=TF.BLOCK_ROWS)
    fb_cpu = FullBatchGraph.from_coo(small.src, small.dst, 3000, device="cpu", **kw)
    fb_gpu = FullBatchGraph.from_coo(small.src, small.dst, 3000, device=dev, **kw)
    if not fb_cpu.slab.fb_src.shape[0]:
        raise AssertionError("the small graph has no fallback edges")
    feats_gpu, labels_gpu = small.feats.to(dev), small.labels.to(dev)
    for name, cls in (("graphsage", GraphSAGE), ("gcn", GCN)):
        torch.manual_seed(3)
        m_cpu = cls(16, 32, 5, device="cpu")
        m_gpu = cls(16, 32, 5, device=dev)
        m_gpu.load_state_dict(m_cpu.state_dict())
        o_cpu = torch.optim.Adam(m_cpu.parameters(), lr=TF.LR)
        o_gpu = torch.optim.Adam(m_gpu.parameters(), lr=TF.LR)
        loss_diff = 0.0
        for _ in range(3):
            l_cpu = TF.full_batch_step(m_cpu, o_cpu, small.feats, fb_cpu, small.labels)
            l_gpu = TF.full_batch_step(m_gpu, o_gpu, feats_gpu, fb_gpu, labels_gpu)
            loss_diff = max(loss_diff, abs(float(l_cpu) - float(l_gpu)))
        if not loss_diff <= 1e-4:
            raise AssertionError(f"small full-batch {name} f32 steps: card vs CPU "
                                 f"loss differ by {loss_diff}")
        emit({"phase": "small_input_agreement_full_batch", "model": name,
              "steps": 3, "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})

    # -- 9. full-batch train at full width ----------------------------------
    x, labels = g.feats.to(torch.bfloat16), g.labels
    reused = {"src": g.src, "dst": g.dst, "fbg": fbg, "feats": g.feats,
              "labels": labels}
    del g
    torch.cuda.empty_cache()
    steps = 4
    totals = {"slab_spmm_band": 0, "csr_spmm": 0}
    for name, cls in (("graphsage", GraphSAGE), ("gcn", GCN)):
        torch.manual_seed(0)
        model = cls(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES, dtype=torch.bfloat16,
                    device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        timed = []
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = TF.full_batch_step(model, opt, x, fbg, labels)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            v = float(loss)
            if not math.isfinite(v):
                raise AssertionError(f"{name}: non-finite loss at step {step}")
            if step:
                timed.append(dt)
            emit({"phase": "full_batch_train", "model": name, "step": step,
                  "warmup": step == 0, "loss": v, "ms_per_step": dt * 1e3,
                  "edges_per_s": edges / dt})
        launches = {fn.__name__: fn.launches for fn in counters}
        want = {**{fn.__name__: 0 for fn in counters},
                "slab_spmm_band": 3 * steps, "csr_spmm": 3 * steps}
        emit({"phase": "full_batch_launch_counts", "model": name, "steps": steps,
              "launches": launches, "expected": want,
              "ms_per_step": sum(timed) * 1e3 / len(timed),
              "edges_per_s": edges * len(timed) / sum(timed),
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if launches != want:
            raise AssertionError(f"{name}: kernel launches {launches}, expected {want}")
        for k in totals:
            totals[k] += launches[k]
        emit({"phase": "full_batch_stages", "model": name,
              "ms": _staged_step(model, opt, x, fbg, labels, F)})
        with torch.no_grad():
            logits = model.full_graph(x, fbg)
        if logits.shape != (n, TF.CLASSES) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} not finite")
        del model, opt, logits

    def kernel_row(name, source, replaces, launches, err):
        rows = timing[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err,
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations",
                "library_ms": sum(r["library_ms"] for r in rows)}

    # each row's times are one training step's three calls added together
    return reused, [
        kernel_row("slab_spmm", "cugraph_gnn_tpu_torch/csrc/slab_spmm.cu",
                   "cugraph_gnn_tpu/ops/pallas/slab_kernel.py:267",
                   totals["slab_spmm_band"], errs["slab_spmm"]),
        kernel_row("csr_spmm", "cugraph_gnn_tpu_torch/csrc/csr_spmm.cu",
                   "cugraph_gnn_tpu/ops/pallas/spmm_kernel.py:90",
                   totals["csr_spmm"], errs["csr_spmm"]),
    ]


def gat_full_batch(dev, emit, cuda_ms, hbm, counters, reused):
    """Phases 10-13 (see the module docstring) on the graph of phase 6.
    Returns the ``kernels`` rows of the attention kernels."""
    import torch
    from torch.nn import functional as F

    from cugraph_gnn_tpu_torch import train_full as TF
    from cugraph_gnn_tpu_torch.models.zoo import GAT
    from cugraph_gnn_tpu_torch.ops.full_batch import FullBatchGraph
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import (
        slab_attention_spmm_mh,
        slab_attention_spmm_mh_ref,
    )

    fbg = reused["fbg"]
    n = fbg.num_nodes
    edges = len(reused["src"])

    # -- 10. attention pairs --------------------------------------------------
    t0 = time.perf_counter()
    fbg512 = FullBatchGraph.from_coo(reused["src"], reused["dst"], n, reorder="none",
                                     block_rows=512, device=dev)
    graph512_s = time.perf_counter() - t0
    pairs = {256: fbg.attention_pair, 512: fbg512.attention_pair}
    torch.cuda.synchronize()

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def valid(t):
        return int((t >= 0).sum())

    emit({"phase": "attention_pairs", "full_batch_graph_512_s": graph512_s,
          "build_seconds": {r: f.build_seconds for r, f in ((256, fbg), (512, fbg512))},
          **{f"R{r}": {"band_fraction": p.fwd.band_fraction,
                       "band_edges": valid(p.fwd.ell), "fallback_edges": valid(p.fwd.fb_src),
                       "ell_k": p.fwd.ell.shape[1],
                       "t_ell_k": None if p.t_ell is None else p.t_ell.shape[1],
                       "transpose_index_bytes": nbytes(p.t_ell, p.t_rowptr, p.t_rows)}
             for r, p in pairs.items()}})
    if pairs[256].t_ell is not None or pairs[512].t_ell is None:
        raise AssertionError("R = 256 must take the band CSR, R = 512 t_ell")

    # -- 11. attention kernels at full width ---------------------------------
    def check(name, got, want, magnitude, what):
        """Within 1e-5 absolute plus 1e-5 of ``magnitude``; returns the max
        abs difference."""
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not bool((diff <= 1e-5 + 1e-5 * magnitude).all()):
            raise AssertionError(f"{name} {what}: off its plain version by "
                                 f"{float(diff.max())}")
        return float(diff.max())

    def bound(nb, ops):
        b_ms, o_ms = nb / hbm * 1e3, ops / H100_F32_OPS * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    layers = {"layer0": (TF.HEADS, TF.HIDDEN // TF.HEADS), "layer1": (1, TF.CLASSES)}
    names = ("slab_attention_fwd", "slab_attention_bwd_onepass", "slab_attention_bwd",
             "slab_attention_bwd_mh")
    timing = {k: [] for k in names}
    errs = {k: 0.0 for k in names}
    gen = torch.Generator(device=dev).manual_seed(11)
    for r_blk, pair in pairs.items():
        graph = pair.fwd
        e_all = valid(graph.ell) + valid(graph.fb_src)
        graph_bytes = nbytes(graph.ell, graph.fb_rowptr, graph.fb_src)
        t_bytes = nbytes(pair.t_ell, pair.t_rowptr, pair.t_rows, pair.fb_t_rowptr,
                         pair.fb_t_dst)
        for layer, (h, f) in layers.items():
            x = torch.randn((n, h, f), generator=gen, device=dev)
            ad, as_ = (torch.randn((n, h), generator=gen, device=dev) for _ in range(2))
            g = torch.randn((n, h, f), generator=gen, device=dev)
            what = f"R={r_blk} {layer} H={h} F={f}"
            out, m, s = slab_attention_spmm_mh(graph, x, ad, as_, return_stats=True)
            want, m_w, s_w = slab_attention_spmm_mh_ref(graph, x, ad, as_, return_stats=True)
            e_f = check("slab_attention_fwd", out, want,
                        slab_attention_spmm_mh_ref(graph, x.abs(), ad, as_), what)
            if not torch.equal(m, m_w) or not torch.allclose(s, s_w, rtol=1e-5, atol=0):
                raise AssertionError(f"slab_attention_fwd {what}: stats differ")
            errs["slab_attention_fwd"] = max(errs["slab_attention_fwd"], e_f)
            del want, m_w, s_w
            if r_blk == 256 and layer == "layer0":
                xb = x.to(torch.bfloat16)
                e_b = check("slab_attention_fwd", slab_attention_spmm_mh(graph, xb, ad, as_),
                            slab_attention_spmm_mh_ref(graph, xb, ad, as_),
                            slab_attention_spmm_mh_ref(graph, xb.float().abs(), ad, as_),
                            what + " bf16 x")
                emit({"phase": "attention_kernel_check", "kernel": "slab_attention_fwd",
                      "case": what + " bf16 x", "max_abs_err": e_b})
                del xb
            t = (g * out).sum(-1)
            key = ("slab_attention_bwd_onepass" if pair.t_ell is None else
                   "slab_attention_bwd" if h == 1 else "slab_attention_bwd_mh")
            got = AG.slab_attention_bwd_mh(pair, x, ad, as_, m, s, t, g)
            ref = AG.slab_attention_bwd_ref(pair, x, ad, as_, m, s, t, g)
            mag = AG.slab_attention_bwd_ref(pair, x.abs(), ad, as_, m, s, -t.abs(), g.abs())
            e_b = max(check(key, a, b, c, f"{what} {nm}")
                      for a, b, c, nm in zip(got, ref, mag, ("dx", "dad", "das")))
            errs[key] = max(errs[key], e_b)
            del got, ref, mag
            emit({"phase": "attention_kernel_check", "case": what,
                  "max_abs_err": {"slab_attention_fwd": e_f, key: e_b},
                  "tolerance": "1e-5 abs + 1e-5 x the terms' magnitude sum; "
                               "m equal, s within 1e-5"})
            torch.cuda.empty_cache()

            # times at the main path's calls: both layers at R = 256 (rows 5
            # and 6); at R = 512 the backward (rows 7 and 8)
            hf = h * f
            rows_out = []
            if r_blk == 256:
                fb_ = nbytes(x, ad, as_) + graph_bytes + 4 * n * hf + 8 * n * h
                rows_out.append(("slab_attention_fwd", fb_, e_all * h * (2 * f + 5),
                                 lambda: slab_attention_spmm_mh(graph, x, ad, as_,
                                                                return_stats=True),
                                 lambda: slab_attention_spmm_mh_ref(graph, x, ad, as_,
                                                                    return_stats=True)))
            bb = (nbytes(x, g, ad, as_, m, s, t) + graph_bytes + t_bytes
                  + 4 * n * hf + 8 * n * h)
            rows_out.append((key, bb, e_all * h * (4 * f + 10),
                             lambda: AG.slab_attention_bwd_mh(pair, x, ad, as_, m, s, t, g),
                             lambda: AG.slab_attention_bwd_ref(pair, x, ad, as_, m, s, t, g)))
            for name, nb, ops, kern, plain in rows_out:
                b_ms, b_by = bound(nb, ops)
                row = {"kernel": name, "block_rows": r_blk, "layer": layer, "heads": h,
                       "f": f, "dtype": "float32", "edges": e_all,
                       "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                       "library_ms": None, "bytes": nb, "operations": ops,
                       "bound_ms": b_ms, "bound_by": b_by}
                emit(row)
                timing[name].append(row)
            del x, ad, as_, g, out, m, s, t
            torch.cuda.empty_cache()

    # -- 12. small input, GAT: card against CPU -------------------------------
    small = TF.make_synthetic_banded(3, "cpu", num_nodes=3000, deg=8, band=100,
                                     feat_dim=16, classes=5)
    kw = dict(reorder="none", block_rows=TF.BLOCK_ROWS)
    fb_cpu = FullBatchGraph.from_coo(small.src, small.dst, 3000, device="cpu", **kw)
    fb_gpu = FullBatchGraph.from_coo(small.src, small.dst, 3000, device=dev, **kw)
    torch.manual_seed(3)
    m_cpu = GAT(16, 32, 5, heads=TF.HEADS, device="cpu")
    m_gpu = GAT(16, 32, 5, heads=TF.HEADS, device=dev)
    m_gpu.load_state_dict(m_cpu.state_dict())
    o_cpu = torch.optim.Adam(m_cpu.parameters(), lr=TF.LR)
    o_gpu = torch.optim.Adam(m_gpu.parameters(), lr=TF.LR)
    loss_diff = 0.0
    for _ in range(3):
        l_cpu = TF.full_batch_step(m_cpu, o_cpu, small.feats, fb_cpu, small.labels)
        l_gpu = TF.full_batch_step(m_gpu, o_gpu, small.feats.to(dev), fb_gpu,
                                   small.labels.to(dev))
        loss_diff = max(loss_diff, abs(float(l_cpu) - float(l_gpu)))
    if not loss_diff <= 1e-4:
        raise AssertionError(f"small full-batch GAT f32 steps: card vs CPU loss "
                             f"differ by {loss_diff}")
    emit({"phase": "small_input_agreement_full_batch", "model": "gat", "steps": 3,
          "max_loss_abs_diff": loss_diff, "tolerance": 1e-4})

    # -- 13. full-batch GAT train at full width ------------------------------
    x, labels = reused["feats"], reused["labels"]
    totals = {fn.__name__: 0 for fn in counters}

    def train(graph, steps, want_per_step, tag):
        torch.manual_seed(0)
        model = GAT(TF.FEAT_DIM, TF.HIDDEN, TF.CLASSES, heads=TF.HEADS, device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=TF.LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        timed = []
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = TF.full_batch_step(model, opt, x, graph, labels)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            v = float(loss)
            if not math.isfinite(v):
                raise AssertionError(f"gat {tag}: non-finite loss at step {step}")
            if step or steps == 1:
                timed.append(dt)
            emit({"phase": "full_batch_train", "model": "gat", "graph": tag,
                  "step": step, "warmup": step == 0 and steps > 1, "loss": v,
                  "ms_per_step": dt * 1e3, "edges_per_s": edges / dt})
        launches = {fn.__name__: fn.launches for fn in counters}
        want = {**{fn.__name__: 0 for fn in counters},
                **{k: v * steps for k, v in want_per_step.items()}}
        emit({"phase": "full_batch_launch_counts", "model": "gat", "graph": tag,
              "steps": steps, "launches": launches, "expected": want,
              "ms_per_step": sum(timed) * 1e3 / len(timed),
              "edges_per_s": edges * len(timed) / sum(timed),
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
        if launches != want:
            raise AssertionError(f"gat {tag}: kernel launches {launches}, expected {want}")
        for k in totals:
            totals[k] += launches[k]
        return model, opt

    model, opt = train(fbg, 4, {"slab_attention_spmm_mh": 2, "onepass_bwd": 2}, "R256")
    emit({"phase": "full_batch_stages", "model": "gat",
          "ms": {**_staged_step(model, opt, x, fbg, labels, F,
                                method="attention_spmm_mh", label="attention"),
                 "fallback": "inside the attention kernels"}})
    with torch.no_grad():
        logits = model.full_graph(x, fbg)
    if logits.shape != (n, TF.CLASSES) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"gat: logits {tuple(logits.shape)} not finite")
    del model, opt, logits
    torch.cuda.empty_cache()
    model, opt = train(fbg512, 1, {"slab_attention_spmm_mh": 2, "slab_attention_bwd": 1,
                                   "slab_attention_bwd_mh": 1}, "R512")
    del model, opt, fbg512
    torch.cuda.empty_cache()

    def kernel_row(name, replaces, counter):
        rows = timing[name]
        return {"name": name, "route": "cuda",
                "source": "cugraph_gnn_tpu_torch/csrc/" + (
                    "slab_attn_fwd.cu" if name == "slab_attention_fwd" else "slab_attn_bwd.cu"),
                "replaces": replaces, "launches": totals[counter],
                "max_abs_err": errs[name], "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations", "library_ms": None}

    # rows 5 and 6: one R = 256 step's two calls added; rows 7 and 8: the
    # R = 512 step's call of each
    return [
        kernel_row("slab_attention_fwd", "cugraph_gnn_tpu/ops/pallas/slab_kernel.py:438",
                   "slab_attention_spmm_mh"),
        kernel_row("slab_attention_bwd_onepass",
                   "cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py:333", "onepass_bwd"),
        kernel_row("slab_attention_bwd", "cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py:507",
                   "slab_attention_bwd"),
        kernel_row("slab_attention_bwd_mh",
                   "cugraph_gnn_tpu/ops/pallas/slab_attn_grad.py:689",
                   "slab_attention_bwd_mh"),
    ]


def _staged_step(model, opt, x, fbg, labels, F, method="spmm", label="spmm"):
    """One full-batch step with CUDA events around its stages: the graph
    aggregations (``fbg.<method>``: the slab SpMMs, forward and backward
    through the transpose, or the attention kernels, forward and backward),
    the rest of forward and backward (Linears, ReLU, casts, scores; loss
    backward), the loss and Adam.  Returns milliseconds per stage, the
    aggregations' under ``label``."""
    import torch

    def event():
        return torch.cuda.Event(enable_timing=True)

    class Mark(torch.autograd.Function):
        """Identity whose backward records ``ev``: two marks bracket the
        backward of what lies between them."""

        @staticmethod
        def forward(ctx, t, ev):
            ctx.ev = ev
            return t.view_as(t)

        @staticmethod
        def backward(ctx, grad):
            ctx.ev.record()
            return grad, None

    fwd, bwd = [], []

    def timed(h, *args, **kw):
        grad = h.requires_grad
        if grad:
            start, end = event(), event()
            h = Mark.apply(h, end)
        a, b = event(), event()
        a.record()
        out = getattr(fbg, method)(h, *args, **kw)
        b.record()
        fwd.append((a, b))
        if grad:
            out = Mark.apply(out, start)
            bwd.append((start, end))
        return out

    class Timed:
        """``fbg`` with every ``method`` call bracketed by events."""

        def __getattr__(self, name):
            return timed if name == method else getattr(fbg, name)

    ev = {k: (event(), event()) for k in ("forward", "loss", "backward", "adam")}
    opt.zero_grad(set_to_none=True)
    ev["forward"][0].record()
    logits = model.full_graph(x, Timed()).float()
    ev["forward"][1].record()
    ev["loss"][0].record()
    loss = F.cross_entropy(logits, labels)
    ev["loss"][1].record()
    ev["backward"][0].record()
    loss.backward()
    ev["backward"][1].record()
    ev["adam"][0].record()
    opt.step()
    ev["adam"][1].record()
    torch.cuda.synchronize()
    ms = {k: a.elapsed_time(b) for k, (a, b) in ev.items()}
    agg_fwd = sum(a.elapsed_time(b) for a, b in fwd)
    agg_bwd = sum(a.elapsed_time(b) for a, b in bwd)
    return {f"{label}_kernels": agg_fwd + agg_bwd, f"{label}_forward": agg_fwd,
            f"{label}_backward": agg_bwd,
            "linears_and_elementwise": ms["forward"] - agg_fwd
            + ms["backward"] - agg_bwd,
            "loss": ms["loss"], "adam": ms["adam"], f"{label}_calls": [len(fwd), len(bwd)]}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from cugraph_gnn_tpu_torch import _build, _native
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
    from cugraph_gnn_tpu_torch.ops.kernels import slab_attn_grad as AG
    from cugraph_gnn_tpu_torch.ops.kernels.slab_attn_kernel import slab_attention_spmm_mh
    from cugraph_gnn_tpu_torch.ops.kernels.slab_kernel import slab_spmm_band
    from cugraph_gnn_tpu_torch.ops.kernels.spmm_kernel import csr_spmm

    wall0 = time.perf_counter()

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
    built = _build.build(["gather_rows", "uniform_sample", "slab_spmm", "csr_spmm",
                          "slab_attn_fwd", "slab_attn_bwd"])
    wall = time.perf_counter() - t0
    for name, b in built.items():
        print(f"build {name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "ptxas" in line:
                print(f"  {line.strip()}")
    t0 = time.perf_counter()
    if not _native.have_native():
        raise RuntimeError("the host graph builders did not build (no g++)")
    emit({"phase": "build", "wall_s": wall,
          "seconds": {n: b.seconds for n, b in built.items()},
          "host_library_s": time.perf_counter() - t0})

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
    counters = (gather_rows, fused_uniform_sample, slab_spmm_band, csr_spmm,
                slab_attention_spmm_mh, AG.onepass_bwd, AG.slab_attention_bwd,
                AG.slab_attention_bwd_mh)
    for fn in counters:
        fn.launches = 0
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
    launches = {fn.__name__: fn.launches for fn in counters}
    want = {**{fn.__name__: 0 for fn in counters},
            "gather_rows": T.REPS * blocks, "fused_uniform_sample": 2 * blocks}
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
    sampled_launches = launches
    del graph, sample, blk_sample, hop_inputs, ids, seeds, u0, u1, x, st, logits
    torch.cuda.empty_cache()

    reused, fb_rows = full_batch(dev, emit, cuda_ms, hbm, counters)
    gat_rows = gat_full_batch(dev, emit, cuda_ms, hbm, counters, reused)
    del reused

    # -- 14. summary --------------------------------------------------------
    kernels.append({
        "name": "gather_rows", "route": "cuda",
        "source": "cugraph_gnn_tpu_torch/csrc/gather_rows.cu",
        "replaces": "cugraph_gnn_tpu/ops/pallas/gather_kernel.py:54",
        "launches": sampled_launches["gather_rows"], "max_abs_err": a_err,
        "ms": a_row["ms"], "plain_ms": a_row["plain_ms"],
        "bound_ms": a_row["bound_ms"], "bound_by": "bytes",
        "library_ms": a_row["library_ms"]})
    # the sampler's numbers are one block's two launches (hop 0 + hop 1)
    kernels.append({
        "name": "uniform_sample", "route": "cuda",
        "source": "cugraph_gnn_tpu_torch/csrc/uniform_sample.cu",
        "replaces": "cugraph_gnn_tpu/ops/pallas/sample_kernel.py:64",
        "launches": sampled_launches["fused_uniform_sample"], "max_abs_err": 0,
        "ms": sum(r["ms"] for r in b_rows),
        "plain_ms": sum(r["plain_ms"] for r in b_rows),
        "bound_ms": sum(r["bound_ms"] for r in b_rows), "bound_by": "bytes",
        "library_ms": None})
    kernels += fb_rows + gat_rows
    emit({"phase": "wall", "seconds": time.perf_counter() - wall0})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
