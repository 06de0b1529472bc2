"""The device's wall time of IGEV-Stereo's geometry stage a pair: from the
group-wise volume's correlation kernel's start to the first combined-lookup
kernel's start after it, within one forward (the volume, its 3-D stem and
excitation, the hourglass, the classifier, the regression and both
pyramids, with the graph's gaps), averaged over the slice's forwards and
divided by the pairs a forward serves. Forwards are told apart by the
request's host-to-device copies, which start each one. A program without
either kernel gives None."""

from stereo_bench import trace

UNIT = "ms"
VOLUME, LOOKUP = "correlation_kernel", "geo_lookup_kernel"


def stage_us(win: dict) -> list[float]:
    """Each forward's interval from the volume kernel to the first lookup."""
    out, volume = [], None
    for name, start, _, cat in sorted(win["device"], key=lambda e: e[1]):
        if cat == "gpu_memcpy" and "HtoD" in name:
            volume = None
        elif cat == "kernel" and VOLUME in name:
            volume = start
        elif cat == "kernel" and LOOKUP in name and volume is not None:
            out.append(start - volume)
            volume = None
    return out


def read(windows: list[dict]) -> float | None:
    return trace._mean([sum(s) / len(s) / 1e3 * w["requests"] / w["pairs"]
                        for w in windows if w.get("pairs") and w.get("requests") and (s := stage_us(w))])
