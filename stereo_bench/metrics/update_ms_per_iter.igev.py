"""The device's wall time of one IGEV-Stereo update iteration, the graph's
gaps included: from one combined-lookup kernel's start to the next one's
start within one forward, averaged over the slice. Forwards are told apart
by the request's host-to-device copies, which start each one. A program
without the kernel gives None."""

from stereo_bench import trace

UNIT = "ms"
LOOKUP = "geo_lookup_kernel"


def iteration_us(win: dict) -> list[float]:
    """Each interval between consecutive lookups' starts inside a forward."""
    out, previous = [], None
    for name, start, _, cat in sorted(win["device"], key=lambda e: e[1]):
        if cat == "gpu_memcpy" and "HtoD" in name:
            previous = None
        elif cat == "kernel" and LOOKUP in name:
            if previous is not None:
                out.append(start - previous)
            previous = start
    return out


def read(windows: list[dict]) -> float | None:
    return trace._mean([sum(gaps) / len(gaps) / 1e3 for w in windows if (gaps := iteration_us(w))])
