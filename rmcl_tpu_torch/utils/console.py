"""Console UX helpers: ANSI text colors and setup banners.

Counterpart of ``rmcl_tpu.utils.console``: the reference's
``text_colors.h`` palette and the MICP startup report (``printSetup``,
micp_localization.cpp:313-411), which prints the map, each sensor's
configuration and whether it has data. Colors are off when stdout is not a
TTY (or as ``force`` says).
"""

from __future__ import annotations

import sys
from typing import Optional


class TextColors:
    """reference rmcl_ros/include/rmcl_ros/util/text_colors.h."""

    HEADER = "\033[95m"
    BLUE = "\033[94m"
    CYAN = "\033[96m"
    GREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    END = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


def colorize(text: str, color: str, force: Optional[bool] = None) -> str:
    enabled = force if force is not None else sys.stdout.isatty()
    if not enabled:
        return text
    return f"{color}{text}{TextColors.END}"


def _fmt_bool(v: bool, force=None) -> str:
    return colorize("yes", TextColors.GREEN, force) if v else colorize(
        "no", TextColors.WARNING, force
    )


def micp_setup_banner(node, color: Optional[bool] = None) -> str:
    """Render the MICP-L setup report (reference printSetup semantics:
    banner, map summary, per-sensor blocks with data/topic status)."""
    import numpy as np

    c = lambda t, col: colorize(t, col, color)
    lines = [
        c("-------------------------", TextColors.BLUE),
        c("     --- BACKENDS ---    ", TextColors.BLUE),
        c("-------------------------", TextColors.BLUE),
        "Available combining units:",
        "- " + c("CPU", TextColors.CYAN) + " (host orchestration)",
        "- " + c("GPU", TextColors.CYAN) + " (hand-written CUDA kernels)",
        "Available raytracing backends:",
        "- " + c("exact BVH", TextColors.CYAN) + " (preorder-threaded traversal)",
        "- " + c("dense binned", TextColors.CYAN) + " (gather-free frustum-culled)",
        f"Node device: {getattr(node, 'device', 'unknown')}",
        c("-------------------------", TextColors.BLUE),
        c("       --- MAP ---       ", TextColors.BLUE),
        c("-------------------------", TextColors.BLUE),
    ]
    m = getattr(node, "map", None)
    if m is not None and getattr(m, "mesh", None) is not None:
        mesh = m.mesh
        lines.append(
            f"- triangles: {mesh.faces.shape[0]}, vertices: {mesh.vertices.shape[0]}"
        )
        vmin = np.asarray(mesh.vertices).min(0)
        vmax = np.asarray(mesh.vertices).max(0)
        lines.append(f"- aabb: {np.round(vmin, 2).tolist()} .. {np.round(vmax, 2).tolist()}")
    lines += [
        c("-------------------------", TextColors.BLUE),
        c("     --- SENSORS ---     ", TextColors.BLUE),
        c("-------------------------", TextColors.BLUE),
    ]
    for name, s in getattr(node, "sensors", {}).items():
        lines.append("- " + c(name, TextColors.BOLD))
        cfg = s.config
        lines.append(f"  - correspondences: {cfg.corr_type}")
        lines.append(
            f"  - max_dist: {float(cfg.max_dist)} "
            f"(adaptive min {float(cfg.adaptive_max_dist_min)})"
        )
        lines.append(f"  - weight: {float(cfg.weight)}")
        lines.append(f"  - data: {_fmt_bool(s.has_data(), color)}")
        if s.model is not None:
            lines.append(f"  - model: {type(s.model).__name__}")
    lines.append(
        "MICP load parameters: "
        + c("done", TextColors.GREEN)
        + f" ({len(getattr(node, 'sensors', {}))} sensors)"
    )
    return "\n".join(lines)
