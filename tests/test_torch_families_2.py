"""The dense family's gemma3-12b (5:1 local/global, qk-norm, sandwich
norms, GELU) and paligemma-3b backbone (a prefix of 8 patch embeddings),
and the moe family's moonshot-v1-16b-a3b (multi-head attention, untied
embeddings, 4 experts top-2 at ``smoke()``), through the port against
the live JAX reference, on the CPU: the checks of
``test_torch_families.py`` (``_families.py``), at ``smoke()`` width in
f32.
"""
import pytest
import torch

from _families import (MOE_FEATURES, SCHEDULES, check_cat_w4a4_logits,
                       check_checkpoint_round_trip, check_engine_feature,
                       check_engine_tokens, check_fp_logits, check_loss,
                       make_cases)

torch.set_num_threads(1)

ARCHS = ["gemma3_12b", "paligemma_3b", "moonshot_v1_16b_a3b"]


@pytest.fixture(scope="module")
def cases():
    return make_cases()


@pytest.mark.parametrize("arch", ARCHS)
def test_fp_logits_match_live_jax(cases, arch):
    check_fp_logits(cases, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cat_w4a4_logits_match_live_jax(cases, arch):
    check_cat_w4a4_logits(cases, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_live_jax(cases, arch):
    check_loss(cases, arch)


@pytest.mark.parametrize("arch", ["gemma3_12b", "paligemma_3b",
                                  "moonshot_v1_16b_a3b"])
def test_checkpoint_round_trips_on_the_reference_layout(cases, arch,
                                                        tmp_path):
    check_checkpoint_round_trip(cases, arch, tmp_path)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_live_jax(cases, arch, schedule):
    check_engine_tokens(cases, arch, schedule)


@pytest.mark.parametrize("feature", sorted(MOE_FEATURES))
def test_moe_engine_features_equal_live_jax(cases, feature):
    check_engine_feature(cases, "moonshot_v1_16b_a3b", feature)
