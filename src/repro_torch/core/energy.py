"""Energy & running-time system model (paper §4.1, Eq. 3–7) + device fleet.

    T_com^n = S_n / V_net          (model bytes / bandwidth)
    T_tra^n = L_n / C_n            (local samples / samples-per-second)
    E_tra^n = P_train * T_tra^n
    E_com^n = P_com  * T_com^n
    T_all   = max_n (T_com^n + T_tra^n)           (Eq. 3–4)
    E_all   = sum_n (E_remain^n - E_tra^n - E_com^n)   (Eq. 6)

Device tiers are calibrated to the paper's test-bed (Jetson Nano vs AGX
Xavier; 7,560 J battery = 1,500 mAh @ 5.04 V).  ``C`` additionally scales
with the *submodel fraction* — training a 1/4-depth Model_1 costs ~1/4 the
per-sample compute of the full backbone (the paper's "variations in the
size of the model lead to fluctuations in the energy consumed").

The MARL selector may also tune the device power mode (the paper's
"adjust the computing capability of AIoT devices"): mode ``turbo`` trades
higher P_train for higher C.

Copied from ``repro.core.energy`` (numpy only); the vectorized engine is
:mod:`repro_torch.core.fleet`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

BATTERY_JOULES = 7_560.0  # 1500 mAh @ 5.04 V (paper §5)

# tier -> (samples/s at full model, P_train W, P_com W)
DEVICE_TIERS = {
    "small": (120.0, 4.0, 1.5),     # Jetson-Nano-class
    "medium": (300.0, 8.0, 2.0),
    "large": (700.0, 18.0, 2.5),    # AGX-Xavier-class
}

POWER_MODES = {          # mode -> (compute multiplier, power multiplier)
    "eco": (0.7, 0.55),
    "normal": (1.0, 1.0),
    "turbo": (1.3, 1.6),
}


@dataclasses.dataclass
class DeviceProfile:
    tier: str
    compute: float            # samples/s at full model, normal mode
    p_train: float            # W
    p_com: float               # W
    bandwidth: float = 2.5e6   # bytes/s uplink
    battery: float = BATTERY_JOULES

    @classmethod
    def from_tier(cls, tier: str, rng: Optional[np.random.Generator] = None,
                  jitter: float = 0.15):
        c, pt, pc = DEVICE_TIERS[tier]
        if rng is not None:
            f = lambda v: float(v * rng.uniform(1 - jitter, 1 + jitter))
        else:
            f = float
        return cls(tier=tier, compute=f(c), p_train=f(pt), p_com=f(pc))


@dataclasses.dataclass
class DeviceState:
    profile: DeviceProfile
    remaining: float            # J
    data_size: int              # L_n local samples
    mode: str = "normal"
    alive: bool = True

    def effective_compute(self, model_fraction: float) -> float:
        cm, _ = POWER_MODES[self.mode]
        return self.profile.compute * cm / max(model_fraction, 1e-6)

    def train_power(self) -> float:
        _, pm = POWER_MODES[self.mode]
        return self.profile.p_train * pm


def round_cost(dev: DeviceState, model_bytes: float, model_fraction: float,
               local_epochs: int = 5, batch_size: int = 32):
    """(T_tra, T_com, E_tra, E_com) for one FL round (Eq. 5 & 7)."""
    samples = dev.data_size * local_epochs
    t_tra = samples / dev.effective_compute(model_fraction)
    t_com = 2.0 * model_bytes / dev.profile.bandwidth   # down + up
    e_tra = dev.train_power() * t_tra
    e_com = dev.profile.p_com * t_com
    return t_tra, t_com, e_tra, e_com


def charge(dev: DeviceState, e_tra: float, e_com: float) -> bool:
    """Deduct energy; returns False (and marks dead) on battery exhaustion.

    Matches the paper's failure mode: a device that can train but not
    communicate wastes the training energy (the 'useless training' arm of
    the wooden-barrel effect)."""
    if not dev.alive:
        return False
    need = e_tra + e_com
    if dev.remaining <= need:
        # device attempts the round and dies mid-way; energy is wasted
        dev.remaining = 0.0
        dev.alive = False
        return False
    dev.remaining -= need
    return True


def total_remaining(devices: Sequence[DeviceState]) -> float:
    return float(sum(d.remaining for d in devices))


def make_fleet(n: int, seed: int = 0,
               tier_probs=(0.4, 0.3, 0.3),
               data_sizes: Optional[List[int]] = None) -> List[DeviceState]:
    """Heterogeneous fleet: 40%% small / 30%% medium / 30%% large by default
    (paper RQ2 uses 20 Nano + 20 Xavier; benchmarks override tier_probs)."""
    rng = np.random.default_rng(seed)
    tiers = rng.choice(list(DEVICE_TIERS), size=n, p=tier_probs)
    fleet = []
    for i, t in enumerate(tiers):
        prof = DeviceProfile.from_tier(str(t), rng)
        ds = int(data_sizes[i]) if data_sizes is not None else int(rng.integers(200, 1200))
        fleet.append(DeviceState(profile=prof, remaining=prof.battery,
                                 data_size=ds))
    return fleet
