"""Message replay: the runtime loop in place of ROS topics and TF.

Counterpart of ``rmcl_tpu.io.replay``: a :class:`MessageLog` holds a
time-ordered stream of typed records (odometry, scans, clouds) recorded
from a simulator or loaded from NPZ, and :func:`replay` pumps them through
the localization nodes in stamp order — a deterministic, testable
stand-in for live middleware.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from rmcl_tpu_torch.convert import to_numpy as _np
from rmcl_tpu_torch.convert import transform_from_arrays
from rmcl_tpu_torch.io import msgs
from rmcl_tpu_torch.math.se3 import Transform


@dataclasses.dataclass(order=True)
class Record:
    stamp: float
    seq: int
    kind: str = dataclasses.field(compare=False)  # "odom" | "scan" | "cloud" | ...
    channel: str = dataclasses.field(compare=False)
    payload: Any = dataclasses.field(compare=False)


class MessageLog:
    """Time-ordered typed record stream."""

    def __init__(self) -> None:
        self._records: List[Record] = []
        self._seq = 0

    def add(self, stamp: float, kind: str, channel: str, payload: Any) -> None:
        self._records.append(Record(stamp, self._seq, kind, channel, payload))
        self._seq += 1

    def add_odometry(self, stamp: float, tbo: Transform) -> None:
        self.add(stamp, "odom", "tf", tbo)

    def __iter__(self) -> Iterator[Record]:
        return iter(sorted(self._records))

    def __len__(self) -> int:
        return len(self._records)

    def save(self, path: str) -> None:
        """NPZ persistence for array-payload records (odometry + scans), in
        the JAX package's layout: either package loads the other's logs."""
        meta, arrays = [], {}
        for i, r in enumerate(sorted(self._records)):
            if r.kind == "odom":
                arrays[f"r{i}_rot"] = _np(r.payload.rot)
                arrays[f"r{i}_trans"] = _np(r.payload.trans)
            elif r.kind == "cloud":
                arrays[f"r{i}_points"] = _np(r.payload["points"])
                arrays[f"r{i}_mask"] = _np(r.payload["mask"])
            elif r.kind == "scan":
                # ScanStamped: grid info as a fixed 8-vector + range data
                info = r.payload.info
                arrays[f"r{i}_info"] = np.asarray(
                    [info.phi_n, info.theta_n, info.phi_min, info.phi_inc,
                     info.theta_min, info.theta_inc, info.range_min,
                     info.range_max], np.float64)
                arrays[f"r{i}_ranges"] = _np(r.payload.data.ranges)
                if r.payload.data.mask is not None:
                    arrays[f"r{i}_smask"] = _np(r.payload.data.mask)
                if r.payload.data.stamps is not None:
                    arrays[f"r{i}_stamps"] = _np(r.payload.data.stamps)
            elif r.kind == "depth":
                # DepthStamped: pinhole intrinsics as a fixed 8-vector
                info = r.payload.info
                arrays[f"r{i}_dinfo"] = np.asarray(
                    [info.width, info.height, info.fx, info.fy, info.cx,
                     info.cy, info.range_min, info.range_max], np.float64)
                arrays[f"r{i}_ranges"] = _np(r.payload.data.ranges)
                if r.payload.data.mask is not None:
                    arrays[f"r{i}_smask"] = _np(r.payload.data.mask)
            elif r.kind == "ondn":
                # OnDnStamped: per-ray origins AND dirs (fully generic)
                info = r.payload.info
                arrays[f"r{i}_origs"] = _np(info.origs, np.float32)
                arrays[f"r{i}_dirs"] = _np(info.dirs, np.float32)
                arrays[f"r{i}_rlim"] = np.asarray(
                    [info.range_min, info.range_max], np.float64)
                arrays[f"r{i}_ranges"] = _np(r.payload.data.ranges)
                if r.payload.data.mask is not None:
                    arrays[f"r{i}_smask"] = _np(r.payload.data.mask)
            elif r.kind == "o1dn":
                # O1DnStamped: one origin + per-ray dirs (generic LiDAR);
                # rlim carries [range_min, range_max, width, height] (the
                # grid entries are optional for old-log compatibility)
                info = r.payload.info
                w, h = info.grid()
                arrays[f"r{i}_orig"] = _np(info.orig, np.float32)
                arrays[f"r{i}_dirs"] = _np(info.dirs, np.float32)
                arrays[f"r{i}_rlim"] = np.asarray(
                    [info.range_min, info.range_max, w, h], np.float64)
                arrays[f"r{i}_ranges"] = _np(r.payload.data.ranges)
                if r.payload.data.mask is not None:
                    arrays[f"r{i}_smask"] = _np(r.payload.data.mask)
                if r.payload.data.stamps is not None:
                    arrays[f"r{i}_stamps"] = _np(r.payload.data.stamps)
                if r.payload.data.colors is not None:
                    arrays[f"r{i}_colors"] = _np(
                        r.payload.data.colors, np.float32)
            else:
                raise ValueError(f"cannot persist record kind '{r.kind}'")
            meta.append((r.stamp, r.kind, r.channel))
        arrays["meta_stamp"] = np.asarray([m[0] for m in meta])
        arrays["meta_kind"] = np.asarray([m[1] for m in meta])
        arrays["meta_channel"] = np.asarray([m[2] for m in meta])
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str, device="cuda") -> "MessageLog":
        """A log saved by either package; odometry transforms on ``device``."""
        z = np.load(path)
        log = MessageLog()
        for i, (stamp, kind, channel) in enumerate(
            zip(z["meta_stamp"], z["meta_kind"], z["meta_channel"])
        ):
            kind = str(kind)
            if kind == "odom":
                payload = transform_from_arrays(z[f"r{i}_rot"], z[f"r{i}_trans"], device=device)
            elif kind == "scan":
                v = z[f"r{i}_info"]
                payload = msgs.ScanStamped(
                    header=msgs.Header(stamp=float(stamp)),
                    info=msgs.ScanInfo(
                        phi_n=int(v[0]), theta_n=int(v[1]),
                        phi_min=float(v[2]), phi_inc=float(v[3]),
                        theta_min=float(v[4]), theta_inc=float(v[5]),
                        range_min=float(v[6]), range_max=float(v[7]),
                    ),
                    data=msgs.RangeData(
                        ranges=z[f"r{i}_ranges"],
                        mask=z.get(f"r{i}_smask"),
                        stamps=z.get(f"r{i}_stamps"),
                    ),
                )
            elif kind == "depth":
                v = z[f"r{i}_dinfo"]
                payload = msgs.DepthStamped(
                    header=msgs.Header(stamp=float(stamp)),
                    info=msgs.DepthInfo(
                        width=int(v[0]), height=int(v[1]), fx=float(v[2]),
                        fy=float(v[3]), cx=float(v[4]), cy=float(v[5]),
                        range_min=float(v[6]), range_max=float(v[7]),
                    ),
                    data=msgs.RangeData(
                        ranges=z[f"r{i}_ranges"], mask=z.get(f"r{i}_smask")
                    ),
                )
            elif kind == "ondn":
                rl = z[f"r{i}_rlim"]
                payload = msgs.OnDnStamped(
                    header=msgs.Header(stamp=float(stamp)),
                    info=msgs.OnDnInfo(
                        origs=z[f"r{i}_origs"], dirs=z[f"r{i}_dirs"],
                        range_min=float(rl[0]), range_max=float(rl[1]),
                    ),
                    data=msgs.RangeData(
                        ranges=z[f"r{i}_ranges"], mask=z.get(f"r{i}_smask")
                    ),
                )
            elif kind == "o1dn":
                rl = z[f"r{i}_rlim"]
                payload = msgs.O1DnStamped(
                    header=msgs.Header(stamp=float(stamp)),
                    info=msgs.O1DnInfo(
                        orig=z[f"r{i}_orig"], dirs=z[f"r{i}_dirs"],
                        range_min=float(rl[0]), range_max=float(rl[1]),
                        width=int(rl[2]) if len(rl) > 2 else None,
                        height=int(rl[3]) if len(rl) > 3 else None,
                    ),
                    data=msgs.RangeData(
                        ranges=z[f"r{i}_ranges"],
                        mask=z.get(f"r{i}_smask"),
                        stamps=z.get(f"r{i}_stamps"),
                        colors=z.get(f"r{i}_colors"),
                    ),
                )
            else:
                payload = {
                    "points": z[f"r{i}_points"],
                    "mask": z[f"r{i}_mask"],
                }
            log.add(float(stamp), kind, str(channel), payload)
        return log


def replay(
    log: MessageLog,
    handlers: Dict[str, Callable[[Record], None]],
    until: Optional[float] = None,
) -> int:
    """Pump records through per-kind handlers in stamp order; returns the
    number of dispatched records. Unhandled kinds are skipped."""
    n = 0
    for rec in log:
        if until is not None and rec.stamp > until:
            break
        fn = handlers.get(rec.kind)
        if fn is not None:
            fn(rec)
            n += 1
    return n
