"""Environment smoke check of the port.

Counterpart of ``cugraph_gnn_tpu/doctor.py`` (the reference's doctor
plugins): import the package and its core subpackages, check the version,
probe the device and run one tiny sample.  On the card that sample is the
fused sampler's CUDA kernel (``csrc/uniform_sample.cu``), built at first use,
and the report counts its launch.  Run as

    python -m cugraph_gnn_tpu_torch.doctor                # the card
    python -m cugraph_gnn_tpu_torch.doctor --device cpu   # the plain versions

or call ``smoke_check()``.  Without a card it raises, unless the CPU is asked
for.
"""

from __future__ import annotations

import argparse
import warnings


def smoke_check(device=None) -> dict:
    """Import the package, probe ``device`` (default: the card) and sample
    a 4-node ring at fanout 2.  Returns a report dict; raises on a broken
    install, a missing card, or a wrong sample."""
    try:
        import cugraph_gnn_tpu_torch
        import cugraph_gnn_tpu_torch.data      # noqa: F401
        import cugraph_gnn_tpu_torch.loader    # noqa: F401
        import cugraph_gnn_tpu_torch.ops       # noqa: F401
        import cugraph_gnn_tpu_torch.store     # noqa: F401
    except ImportError as e:
        raise ImportError(
            "cugraph_gnn_tpu_torch or its dependencies could not be imported; "
            "the package needs torch and numpy.") from e

    if not getattr(cugraph_gnn_tpu_torch, "__version__", None):
        raise AssertionError("smoke check failed: __version__ missing")

    import torch

    from cugraph_gnn_tpu_torch._device import resolve_device
    from cugraph_gnn_tpu_torch.ops import uniform_sample
    from cugraph_gnn_tpu_torch.ops.kernels.sample_kernel import fused_uniform_sample

    dev = resolve_device(device)
    if dev.type == "cuda":
        name, count = torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        name, count = "cpu", 1
        warnings.warn("the device is the CPU: it runs the kernels' plain PyTorch "
                      "versions; cugraph_gnn_tpu_torch targets an NVIDIA H100")

    # one tiny end-to-end op: 4-node ring, both neighbors of two seeds
    indptr = torch.tensor([0, 2, 4, 6, 8], dtype=torch.int32)
    indices = torch.tensor([1, 3, 0, 2, 1, 3, 0, 2], dtype=torch.int32)
    seeds = torch.tensor([0, 2], dtype=torch.int32)
    before = fused_uniform_sample.launches
    out = uniform_sample(indptr, indices, seeds, 2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    launches = fused_uniform_sample.launches - before
    if out.neighbors.shape != (2, 2):
        raise AssertionError(f"smoke check failed: sample shape {tuple(out.neighbors.shape)}")
    got = sorted(map(tuple, out.neighbors.sort(dim=1).values.cpu().tolist()))
    if got != [(1, 3), (1, 3)]:
        raise AssertionError(f"smoke check failed: ring neighbors {got}, expected (1, 3) twice")

    return {
        "version": cugraph_gnn_tpu_torch.__version__,
        "platform": dev.type,
        "device_name": name,
        "num_devices": count,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "sample_op": "ok",
        "sample_kernel_launches": launches,
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m cugraph_gnn_tpu_torch.doctor")
    p.add_argument("--device", default=None, help="cpu to run without a card")
    report = smoke_check(p.parse_args(argv).device)
    for k, v in report.items():
        print(f"{k}: {v}")
    print("cugraph_gnn_tpu_torch doctor: all checks passed")


if __name__ == "__main__":
    main()
