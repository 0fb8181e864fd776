"""What the run ran on: the card's name, count and power limit, and the SM
clock and power draw sampled by ``nvidia-smi`` beside the window."""

from __future__ import annotations

import shutil
import statistics
import subprocess
import sys

import torch

_QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
          "-i", "0", "-lms", "500"]


def card_missing(chips: int):
    """Why the run cannot measure on ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device is visible"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and {torch.cuda.device_count()} are visible"
    return None


def power_limit_w():
    """The first card's power limit in watts, as ``nvidia-smi`` reads it."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                          "-i", "0"], capture_output=True, text=True, timeout=30)
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


class Sampler:
    """``nvidia-smi`` sampling SM clock (MHz) and power draw (W) every half
    second while the window runs; :meth:`stop` ends and reaps it."""

    def __init__(self):
        self.proc = None
        if shutil.which("nvidia-smi") is not None:
            self.proc = subprocess.Popen(_QUERY, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        clocks, watts = [], []
        for line in out.splitlines():
            try:
                c, w = (float(x) for x in line.split(","))
            except ValueError:
                continue
            clocks.append(c)
            watts.append(w)
        if not clocks:
            return {}
        return {"sm_clock_mhz": _summary(clocks), "power_w": _summary(watts)}


def _summary(xs) -> dict:
    return {"min": min(xs), "median": statistics.median(xs), "max": max(xs), "samples": len(xs)}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
