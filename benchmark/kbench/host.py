"""The host as a run finds it: where the process runs and what the machine
did around it during the window, read from /proc and /sys (a sandboxed
kernel may leave some of it empty)."""

import os
import resource
import time


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _kv(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        k, _, v = line.partition(":")
        if v.strip():
            out[k.strip()] = v.split()[0]
    return out


def _psi_total(kind: str):
    """Microseconds in which some task of the machine stalled on kind (None
    where the kernel keeps no such count)."""
    for line in _read(f"/proc/pressure/{kind}").splitlines():
        if line.startswith("some"):
            return float(line.rsplit("total=", 1)[1])
    return None


def _selected(text: str) -> str:
    """The bracketed choice of a /sys setting ("always [madvise] never")."""
    return text[text.find("[") + 1:text.find("]")] if "[" in text else text


def placement() -> dict:
    """Where the process runs: its CPUs and memory nodes, the machine's
    nodes, its transparent huge page settings, the CPUs' model and clock,
    and the kernel."""
    status = _kv(_read("/proc/self/status"))
    info = _read("/proc/cpuinfo").splitlines()
    mhz = [float(x.split(":")[1]) for x in info if x.startswith("cpu MHz")]
    model = next((x.split(":", 1)[1].strip() for x in info
                  if x.startswith("model name")), "")
    thp = "/sys/kernel/mm/transparent_hugepage/"
    return {
        "cpus_allowed": _read_status_list("Cpus_allowed_list"),
        "cpus_online": _read("/sys/devices/system/cpu/online").strip(),
        "mems_allowed": _read_status_list("Mems_allowed_list"),
        "nodes_online": _read("/sys/devices/system/node/online").strip(),
        "threads": int(status.get("Threads", 0)),
        "thp_enabled": _selected(_read(thp + "enabled")),
        "thp_defrag": _selected(_read(thp + "defrag")),
        "cpu_model": model,
        "cpu_mhz_mean": sum(mhz) / len(mhz) if mhz else None,
        "kernel": os.uname().release,
    }


def _read_status_list(key: str) -> str:
    for line in _read("/proc/self/status").splitlines():
        if line.startswith(key + ":"):
            return line.split(":", 1)[1].strip()
    return ""


def snapshot() -> dict:
    """The counters that delta() compares: the machine's CPU times, its
    stall totals, and the process's CPU, faults, switches and huge pages."""
    cpu = [int(x) for x in _read("/proc/stat").splitlines()[0].split()[1:]]
    ru = resource.getrusage(resource.RUSAGE_SELF)
    mem = _kv(_read("/proc/self/smaps_rollup"))
    vm = dict(line.split() for line in _read("/proc/vmstat").splitlines()
              if line.count(" ") == 1)
    return {
        "t": time.perf_counter(), "cpu": cpu,
        "proc_cpu_s": ru.ru_utime + ru.ru_stime, "minflt": ru.ru_minflt,
        "nivcsw": ru.ru_nivcsw,
        "rss_kib": int(mem.get("Rss", 0)),
        "anon_huge_kib": int(mem.get("AnonHugePages", 0)),
        "psi": {k: _psi_total(k) for k in ("cpu", "io", "memory")},
        "thp_fallback": int(vm.get("thp_fault_fallback", 0)),
        "load1": float((_read("/proc/loadavg") or "0").split()[0]),
    }


def process_times() -> dict:
    """The process's own counters, for one sample's share of them."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "utime_s": ru.ru_utime,
            "stime_s": ru.ru_stime, "minflt": ru.ru_minflt,
            "majflt": ru.ru_majflt, "nvcsw": ru.ru_nvcsw,
            "nivcsw": ru.ru_nivcsw}


def process_delta(a: dict, b: dict) -> dict:
    """One sample's wall seconds, the process's user and system CPU seconds
    in it, and its faults and context switches (a slow sample whose user
    time grew ran on a slower CPU; one whose system time or faults grew
    waited on the kernel)."""
    d = {k: b[k] - a[k] for k in a}
    d["wall_s"] = d.pop("t")
    return d


def delta(a: dict, b: dict) -> dict:
    """What happened between two snapshots: the process's CPU seconds per
    second of wall, the machine's shares of stolen, I/O-wait and busy CPU
    time (%), its stall shares (%), and the process's huge pages at the
    end."""
    wall = b["t"] - a["t"]
    d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
    total = sum(d[:8]) or 1
    user, nice, system, idle, iowait, irq, softirq, steal = d[:8]
    return {
        "proc_cpu_per_wall": (b["proc_cpu_s"] - a["proc_cpu_s"]) / wall,
        "machine_busy_pct": 100.0 * (total - idle - iowait) / total,
        "steal_pct": 100.0 * steal / total,
        "iowait_pct": 100.0 * iowait / total,
        "psi_some_pct": {k: 100.0 * (b["psi"][k] - a["psi"][k]) / 1e6 / wall
                         for k in b["psi"] if b["psi"][k] is not None},
        "minflt": b["minflt"] - a["minflt"],
        "nivcsw": b["nivcsw"] - a["nivcsw"],
        "thp_fallback": b["thp_fallback"] - a["thp_fallback"],
        "rss_gib": b["rss_kib"] / 2**20,
        "anon_huge_gib": b["anon_huge_kib"] / 2**20,
        "anon_huge_gib_before": a["anon_huge_kib"] / 2**20,
        "load1": b["load1"],
    }
