"""MSM window and lane-tile caps (pippenger module constants)."""

from bls12_381_jax.msm import pippenger


class TestChipProfile:
    def test_profile_shapes_msm_knobs(self, monkeypatch):
        from bls12_381_jax.msm.pippenger import lane_tile_for, window_bits_for

        assert window_bits_for(1 << 20) == 15
        assert window_bits_for(1 << 22) == 16
        assert lane_tile_for(1 << 24) == 1 << 15  # capped
        monkeypatch.setattr(pippenger, "MSM_LANE_TILE_LOG_CAP", 16)
        assert lane_tile_for(1 << 24) == 1 << 16  # the cap is the constant

    def test_g2_cost_model(self):
        """Fq2 mul = 3 Fq muls on 2x limb planes -> both caps drop a step."""
        from bls12_381_jax.curves.field_adapters import FQ2_ADAPTER
        from bls12_381_jax.msm.pippenger import lane_tile_for, window_bits_for

        assert window_bits_for(1 << 22, FQ2_ADAPTER) == 15
        assert window_bits_for(1 << 20, FQ2_ADAPTER) == 14
        assert lane_tile_for(1 << 24, FQ2_ADAPTER) == 1 << 14
        # below the caps the size-driven choice is unchanged
        assert window_bits_for(1 << 12, FQ2_ADAPTER) == 11
