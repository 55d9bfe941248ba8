"""Effective tool configuration per preset.

EncoderControl applies documented tool-exclusion guards (params.py:37-78)
— e.g. dep-quant disables RDOQ/LFNST/trskip, dual-tree disables
JCCR/LFNST. This test pins down EXACTLY which tools survive each preset
after those guards, so any silent shedding is explicit and any future
combo unlock (or accidental new exclusion) shows up as a diff here.

Reference preset table: cfg.c:602-900; the EXPECTED_DROPS entries are
the repo's remaining combo gaps (tracked in STATUS round-3 plan #6) —
an empty EXPECTED_DROPS means preset parity with the reference.
"""
import pytest

from uvg266_jax.cfg import PRESETS, make_config
from uvg266_jax.control.params import EncoderControl

TOOLS = ("rdoq_enable", "dep_quant", "lfnst", "trskip_enable", "mts",
         "jccr", "cclm", "mip", "mrl", "dual_tree", "sao_type",
         "deblock_enable", "signhide_enable", "wpp")

# tools a preset requests that the current guards drop/downgrade:
# preset -> {field: (requested, effective)}. The only remaining
# normalization: dep-quant clears the rdoq flag because the trellis IS
# the level decision (the reference's dep-quant path likewise replaces
# RDOQ; rate code keys off dep_quant alone). Everything else runs as
# requested — the round-2 combo locks (lfnst x mts/cclm, dual-tree x
# jccr/lfnst, dep-quant x lfnst/trskip) are unlocked.
EXPECTED_DROPS = {
    "slower": {"rdoq_enable": (True, False)},
    "veryslow": {"rdoq_enable": (True, False)},
    "placebo": {"rdoq_enable": (True, False)},
}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_effective_config(preset):
    cfg = make_config(preset, width=128, height=128)
    requested = {t: getattr(cfg, t, None) for t in TOOLS}
    EncoderControl(cfg)                     # applies the combo guards
    effective = {t: getattr(cfg, t, None) for t in TOOLS}

    drops = {t: (requested[t], effective[t])
             for t in TOOLS if requested[t] != effective[t]}
    assert drops == EXPECTED_DROPS.get(preset, {}), (
        f"preset '{preset}': unexpected tool shedding {drops} "
        f"(expected {EXPECTED_DROPS.get(preset, {})})")
