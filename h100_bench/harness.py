"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct`` and the result line's numbers."""

from __future__ import annotations

import gc
import shutil
from dataclasses import dataclass, field
from pathlib import Path

from h100_bench import check, timeline, tracing
from h100_bench.cells import Cell, load_module
from h100_bench.standin import writers

HERE = Path(__file__).resolve().parent
# The stand-in resource roots and the program's asset caches, inside the
# checkout at fixed paths.
CACHE = HERE / ".cache"
# The stand-in maps are one of this many seeded sets, the seed's
# remainder picking it: a checkout writes each set (~60 MB, and the
# program's ~135 MB asset cache of it) once and later runs read it, so
# that a run's set-up writes nothing and disk writes stay small.
STANDIN_SETS = 4
# The reference of a configuration without a "reference" key.
DEFAULT_REFERENCE = "render"


@dataclass
class RunData:
    """What the per-layer readers read (``metrics/<name>.py``'s
    ``read(run)``)."""

    cell: Cell
    window: object  # the driver's Window
    reference: object  # () -> the cell's plain reference, built once
    frame: dict  # what the counts read besides the passes (ref.facts())
    _rooflines: dict = field(default_factory=dict)

    @property
    def spans(self) -> list:
        return self.window.spans

    @property
    def device(self) -> tracing.DeviceTrace | None:
        return self.window.device

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of a port kernel (``"K1"``..) in the profiled
        segment."""
        return sum(b - a for name, a, b in self.device.ops
                   if tracing.port_kernel(name) == kernel) / 1e6

    def bound_s(self, kernel: str) -> float:
        """The roofline bound (seconds) of ``roofline/<kernel>.py``'s
        count, summed over the profiled segment's frames."""
        if kernel not in self._rooflines:
            import torch

            from h100_bench import peaks

            mod = load_module(self.cell, "roofline", kernel)
            ref = self.reference()
            total = 0.0
            with torch.no_grad():
                for f in self.window.profiled:
                    nbytes, ops = mod.count(ref.passes(*self.window.poses[f]),
                                            self.frame)
                    total += peaks.bound_s(nbytes, ops)
            self._rooflines[kernel] = total
        return self._rooflines[kernel]


def prepare_resources(config: dict, seed: int) -> Path:
    """The seed's stand-in resource root (set ``seed % STANDIN_SETS``),
    and the program pointed at it and at its own asset cache. Returns
    the root."""
    from bibim_tpu_torch.assets import asset_cache
    from bibim_tpu_torch.utils import config as resource_config

    k = seed % STANDIN_SETS
    cfg_path, fresh = writers.prepare(CACHE / "standin" / str(k), k,
                                      config["standin"]["map_size"])
    assets = CACHE / "assets" / str(k)
    if fresh and assets.exists():
        # Entries of a root written over: never read again.
        shutil.rmtree(assets)
    asset_cache.CACHE_DIR = assets
    resource_config.init_resource_root(cfg_path)
    return cfg_path.parent


def reference_frame(ref, pose) -> tuple:
    """The reference's uint8 frame of ``pose`` and its overlay mask, as
    host arrays."""
    img, mask = ref.render(*pose, overlay_mask=True)
    return img.cpu().numpy(), mask.cpu().numpy()


def reference_module(config: dict, dirs=(HERE,)):
    """The plain reference module ``config`` names (``"reference"``, by
    default :data:`DEFAULT_REFERENCE`): ``reference/<name>.py`` of the
    first of ``dirs`` that holds one. It exposes ``make(config, root,
    device, dtype)`` and ``FAULTS``, the faults a control plants in it as
    configuration settings."""
    return load_module(dirs, "reference",
                       config.get("reference", DEFAULT_REFERENCE))


def make_reference(config: dict, root: Path, device: str, dtype=None,
                   dirs=(HERE,)):
    """``config``'s plain reference (:func:`reference_module`) on
    ``device``, every floating-point step in ``dtype`` (float32 unless
    given)."""
    import torch

    return reference_module(config, dirs).make(config, root, device,
                                               dtype or torch.float32)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_process: float, log=print,
             keep: dict | None = None) -> tuple:
    """Returns (result dict for the line, the compared numbers); ``keep``
    receives the compared frames' poses ("poses"), the resource root
    ("root") and every reading ("readings")."""
    import torch

    config, traffic = cell.config, cell.traffic
    root = prepare_resources(config, seed)
    driver = load_module(cell, "drivers", traffic["driver"])
    win = driver.run(config, traffic, seed, seconds, trace, device, log)
    setup_s = win.t_first - t_process
    tl = timeline.summarize(win.calls, win.dropped, win.window_s)
    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    refs = {}

    def reference():
        if "ref" not in refs:
            refs["ref"] = make_reference(config, root, device,
                                         dirs=cell.dirs)
        return refs["ref"]

    frames = [(img, win.poses[f]) for f, img in win.sample
              if f not in win.dropped]
    with torch.no_grad():
        read = check.readings(
            lambda pose: reference_frame(reference(), pose), frames)
    correct, checks = check.verdict(read, config["limits"])
    if keep is not None:
        keep.update(poses=[pose for _, pose in frames], root=root,
                    readings=read)
    call_ms = sorted((c.t1 - c.t0) * 1e3 for c in win.calls)
    if win.device_busy_s is not None:
        log(f"device busy {win.device_busy_s:.4f} s of the window's "
            f"{win.window_s:.3f} s")
    log(f"window: {tl['attempted']} frames in {win.window_s:.3f} s, "
        f"{tl['failed']} failed, {win.retunes} retunes; compared "
        f"{read['frames_compared']} frames; call ms p10 / p50 / p90 / max "
        + " / ".join(f"{call_ms[int(q * (len(call_ms) - 1))]:.2f}"
                     for q in (0.1, 0.5, 0.9, 1.0))
        + f"; frames that dropped geometry {sorted(win.dropped)}")

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = {"setup_s": setup_s, "frame_device_ms": (
            1e3 * win.device_busy_s / tl["attempted"]
            if win.device_busy_s and tl["attempted"] else None)}
        names = [m["name"] for m in cell.end_to_end]
    else:
        data = RunData(cell=cell, window=win, reference=reference,
                       frame=reference().facts())
        values = {m["name"]: load_module(cell, "metrics", m["name"]).read(data)
                  for m in cell.per_layer}
        names = [m["name"] for m in cell.per_layer]
    metrics = {n: {"value": values[n], "unit": units[n]} for n in names
               if values.get(n) is not None}
    result = {"correct": bool(correct), "attempted": tl["attempted"],
              "failed": tl["failed"], "metrics": metrics,
              "device": device_info(device, cell.chips,
                                    win.memory_peak_bytes)}
    if trace and win.device is not None:
        result["device"]["busy_s"] = win.device.busy_s
        result["device"]["window_s"] = win.device.window_s
        result["breakdown"] = win.device.breakdown()
    result["checks"] = checks
    if config["num_instances"] > 1:
        log("visible instances per frame: " + " ".join(
            str(visible_instances(config, pose)) for pose in win.poses))
    return result, checks


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def visible_instances(config: dict, pose) -> int:
    """Balls (radius 1) inside the view frustum of ``pose``."""
    import numpy as np

    from h100_bench.reference import scene as ref_scene

    model, _ = ref_scene.instance_matrices(config["num_instances"])
    centres = np.concatenate([model[:, :3, 3], np.ones((len(model), 1))], 1)
    v = centres @ ref_scene.view_matrix(*pose).T
    half_v = np.radians(ref_scene.FOV_DEGREES / 2)
    half_h = np.arctan(np.tan(half_v) * config["width"] / config["height"])
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    inside = ((z > ref_scene.NEAR - 1.0)
              & (np.abs(x) * np.cos(half_h) - z * np.sin(half_h) <= 1.0)
              & (np.abs(y) * np.cos(half_v) - z * np.sin(half_v) <= 1.0))
    return int(inside.sum())
