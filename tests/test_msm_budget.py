"""The MSM memory budget follows the device's memory limit."""

import pytest

from bls12_381_jax.curves.field_adapters import FQ_ADAPTER
from bls12_381_jax.msm import pippenger

GB = 10 ** 9


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def card(monkeypatch):
    """Make the budget see a device whose memory_stats() is ``stats``."""
    monkeypatch.delenv("MIDNIGHT_MSM_HBM_BUDGET_MB", raising=False)

    def set_(stats):
        monkeypatch.setattr(pippenger.jax, "devices",
                            lambda: [_FakeDevice(stats)])

    return set_


def _pieces_2e24(budget: int) -> int:
    return pippenger._split_points(
        1 << 24, budget, pippenger._msm_bytes_per_point(FQ_ADAPTER))


def test_bigger_card_fewer_pieces(card):
    card({"bytes_limit": 80 * GB})
    big = pippenger._hbm_budget_bytes()
    card({"bytes_limit": 16 * GB})
    small = pippenger._hbm_budget_bytes()
    assert big == int(80 * GB * pippenger.MSM_BUDGET_FRACTION)
    assert _pieces_2e24(big) < _pieces_2e24(small)


def test_env_override_wins(card, monkeypatch):
    card({"bytes_limit": 80 * GB})
    monkeypatch.setenv("MIDNIGHT_MSM_HBM_BUDGET_MB", "1024")
    assert pippenger._hbm_budget_bytes() == 1024 << 20


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_no_limit_keeps_default(card, stats):
    card(stats)
    assert pippenger._hbm_budget_bytes() == (
        pippenger._DEFAULT_BUDGET_MB << 20)
