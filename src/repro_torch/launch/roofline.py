"""Three-term roofline model of a rank's program on an NVIDIA H100 (the port
of ``repro.launch.roofline``).

Terms (seconds per step, per rank):

  t_compute    = flops / peak bf16 tensor rate
  t_memory     = HBM bytes / HBM bandwidth
  t_collective = sum over collectives of their per-rank traffic / the bandwidth
                 of the link their group spans: NVLink inside one node of
                 8 GPUs (a group of consecutive ranks), the network across
                 nodes

with flops, bytes and collective traffic from ``repro_torch.launch.cost``
(the dry run) or a kernel's own count.  The dominant term is the
bottleneck; the roofline fraction is ``t_compute / max(terms)`` (how close
the step is to compute-bound at peak), the step-time bound the largest
term (no overlap).

The peaks are the H100's, from the card present
(``torch.cuda.get_device_properties``: SXM or PCIe) or by name
(``"h100-sxm"``, ``"h100-pcie"``) for a dry run on a CPU.  This module holds
the port's only copy of them; ``chip_smoke.py``'s kernel bounds read them
here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One card's published peak rates (dense, no sparsity) and sizes."""
    name: str
    bf16_flops: float          # tensor cores, bf16 (and fp16) dense
    tf32_flops: float          # tensor cores, TF32 dense
    int8_ops: float            # tensor cores, int8 dense
    fp32_flops: float          # CUDA cores, float32 (also caps 32-bit integer work)
    hbm_bytes_per_s: float     # HBM bandwidth
    memory_bytes: float        # device memory
    nvlink_bytes_per_s: float  # NVLink, one direction, per GPU
    network_bytes_per_s: float  # across nodes, one direction, per GPU


# NVIDIA H100 Tensor Core GPU datasheet (H100 SXM5 column): BF16 1,979
# TFLOP/s and TF32 989 with sparsity, so 989 and 495 dense; INT8 3,958 TOP/s
# with sparsity, 1,979 dense; FP32 67 TFLOP/s; HBM3 3.35 TB/s; 80 GB.
# NVLink 4: 900 GB/s a GPU both ways (18 links of 50 GB/s), 450 GB/s one
# way, inside an HGX H100 node of 8 GPUs.  Across nodes: one 400 Gb/s NDR
# InfiniBand NIC a GPU (the DGX H100's ConnectX-7 layout), 50 GB/s one way.
H100_SXM = Peaks(name="h100-sxm", bf16_flops=989e12, tf32_flops=495e12, int8_ops=1.979e15,
                 fp32_flops=67e12, hbm_bytes_per_s=3.35e12, memory_bytes=80e9,
                 nvlink_bytes_per_s=450e9, network_bytes_per_s=50e9)
# The same datasheet's H100 PCIe column: BF16 1,513 and TF32 756 TFLOP/s
# with sparsity (756 and 378 dense), INT8 3,026 TOP/s (1,513 dense), FP32
# 51 TFLOP/s, HBM2e 2.0 TB/s, 80 GB; NVLink through a bridge joining two
# cards, 600 GB/s both ways (300 one way); the same NIC across nodes.
H100_PCIE = Peaks(name="h100-pcie", bf16_flops=756e12, tf32_flops=378e12, int8_ops=1.513e15,
                  fp32_flops=51e12, hbm_bytes_per_s=2.0e12, memory_bytes=80e9,
                  nvlink_bytes_per_s=300e9, network_bytes_per_s=50e9)
PEAKS = {p.name: p for p in (H100_SXM, H100_PCIE)}


def peaks(which: Union[str, Peaks, None] = None) -> Peaks:
    """The peaks by name, or (``None``) of the card present: its name tells
    PCIe from SXM.  Raises for a card that is not an H100, or without one."""
    if isinstance(which, Peaks):
        return which
    if which is not None:
        if which not in PEAKS:
            raise KeyError(f"unknown peaks {which!r}; known: {sorted(PEAKS)}")
        return PEAKS[which]
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name the peaks (e.g. 'h100-sxm') for a dry run")
    name = torch.cuda.get_device_properties(0).name
    if "H100" not in name:
        raise ValueError(f"peaks are known for the H100 only, not {name!r}")
    return H100_PCIE if "PCIe" in name else H100_SXM


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float                  # 6·N_active·D (train) etc., global
    useful_ratio: float                 # model_flops / (flops_per_device * n)
    roofline_fraction: float            # t_compute / max(terms)
    step_time_bound: float              # max of terms (no-overlap bound)
    peaks: str = H100_SXM.name
    notes: str = ""

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def collective_seconds(costs, p: Peaks) -> float:
    """Each collective's per-rank traffic over its link's bandwidth: NVLink
    inside a node, the network across nodes."""
    return sum(c.traffic_bytes / (p.nvlink_bytes_per_s if c.link == "nvlink"
                                  else p.network_bytes_per_s)
               for c in costs.collectives)


def compute_roofline(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_devices: int,
    costs,
    model_flops: float,
    notes: str = "",
    peaks_of: Union[str, Peaks, None] = "h100-sxm",
) -> Roofline:
    """The three terms of ``costs`` (a ``launch.cost.Costs``: flops,
    hbm_bytes, collective_traffic, collectives) on ``peaks_of``'s card."""
    p = peaks(peaks_of)
    t_c = costs.flops / p.bf16_flops
    t_m = costs.hbm_bytes / p.hbm_bytes_per_s
    t_x = collective_seconds(costs, p)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    global_flops = costs.flops * n_devices
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=costs.flops,
        hbm_bytes_per_device=costs.hbm_bytes,
        collective_bytes_per_device=costs.collective_traffic,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / global_flops) if global_flops else 0.0,
        roofline_fraction=(t_c / max(max(terms.values()), 1e-30)),
        step_time_bound=max(terms.values()),
        peaks=p.name,
        notes=notes,
    )


@dataclasses.dataclass
class KernelRoofline:
    """Achieved-against-peak report for one kernel or step measured on the
    card: ``flops`` / ``hbm_bytes`` its counted work, ``achieved_*`` those
    over the measured time, ``*_frac`` their share of the peaks.
    ``bound_us`` is the no-overlap roofline bound, the time the work could
    not beat at peak; ``gap`` = measured / bound."""
    name: str
    us_measured: float
    flops: float
    hbm_bytes: float
    t_compute: float
    t_memory: float
    bottleneck: str
    achieved_flops_s: float
    achieved_bytes_s: float
    flops_frac: float
    bytes_frac: float
    bound_us: float
    gap: float
    peaks: str = H100_SXM.name

    def columns(self) -> str:
        """The roofline columns of a benchmark row."""
        p = peaks(self.peaks)
        return (f"flops={self.flops:.3g} bytes={self.hbm_bytes:.3g} "
                f"ach_flops={self.achieved_flops_s:.3g}/{p.bf16_flops:.3g} "
                f"ach_bytes={self.achieved_bytes_s:.3g}/{p.hbm_bytes_per_s:.3g} "
                f"bottleneck={self.bottleneck} "
                f"bound_us={self.bound_us:.1f} gap={self.gap:.3g}")

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def kernel_roofline(name: str, costs, us_measured: float,
                    peaks_of: Union[str, Peaks, None] = "h100-sxm") -> KernelRoofline:
    """The roofline of one kernel or single-rank step (no collective term)
    against its measured time."""
    p = peaks(peaks_of)
    r = compute_roofline(arch="kernel", shape=name, mesh_name="1x1", n_devices=1,
                         costs=costs, model_flops=costs.flops, peaks_of=p)
    sec = max(us_measured, 1e-3) / 1e6
    bound = max(max(r.t_compute, r.t_memory), 1e-30)
    return KernelRoofline(
        name=name,
        us_measured=us_measured,
        flops=costs.flops,
        hbm_bytes=costs.hbm_bytes,
        t_compute=r.t_compute,
        t_memory=r.t_memory,
        bottleneck="compute" if r.t_compute >= r.t_memory else "memory",
        achieved_flops_s=costs.flops / sec,
        achieved_bytes_s=costs.hbm_bytes / sec,
        flops_frac=(costs.flops / sec) / p.bf16_flops,
        bytes_frac=(costs.hbm_bytes / sec) / p.hbm_bytes_per_s,
        bound_us=bound * 1e6,
        gap=sec / bound,
        peaks=p.name,
    )


def model_flops_for(cfg, shape_spec, active_params: int) -> float:
    """MODEL_FLOPS per step (global): 6·N·D train, 2·N·D prefill, 2·N·B decode."""
    b, s = shape_spec.global_batch, shape_spec.seq_len
    if shape_spec.kind == "train":
        return 6.0 * active_params * b * s
    if shape_spec.kind == "prefill":
        return 2.0 * active_params * b * s
    return 2.0 * active_params * b  # decode: one token per sequence


def fits(memory_bytes: Optional[float], peaks_of: Union[str, Peaks, None] = "h100-sxm") -> bool:
    """Whether a rank's memory fits the card's."""
    return memory_bytes is not None and memory_bytes < peaks(peaks_of).memory_bytes
