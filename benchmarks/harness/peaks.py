"""The card's peaks that rooflines are taken against, and its power limit.

HBM bandwidth is the published figure of an H100 SXM (NVIDIA's data sheet,
80 GB HBM3). The 32-bit integer multiply rate is 64 INT32 lanes per SM per
clock (a Hopper SM) times the card's SMs times its maximum SM clock, both
read from the card. A card below its 700 W limit runs slower under load, so
the limit is reported beside every roofline share.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def card_peaks(torch) -> dict:
    """``{"hbm_bytes_per_s", "int32_muls_per_s", "power_limit_w", "max_sm_mhz"}``
    of card 0."""
    mhz, watts = (float(v) for v in _smi("clocks.max.sm,power.limit").split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "int32_muls_per_s": INT32_LANES_PER_SM * sms * mhz * 1e6,
        "power_limit_w": watts,
        "max_sm_mhz": mhz,
    }


def bound_s(n_bytes: int, muls: int, peaks: dict) -> float:
    """The least seconds the card could take: the larger of bytes over the
    HBM rate and 32-bit multiplies over the multiply rate."""
    return max(n_bytes / peaks["hbm_bytes_per_s"], muls / peaks["int32_muls_per_s"])


#: what ``card_state`` reads: clocks, temperature, power and why the clocks are held down
STATE_QUERY = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_event_reasons.active"


def card_state() -> str:
    """Card 0's clocks, temperature, power draw and clock-event reasons now,
    as ``nvidia-smi`` gives them (or why it could not)."""
    try:
        return _smi(STATE_QUERY)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"
