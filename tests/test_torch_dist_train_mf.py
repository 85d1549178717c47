"""The checks of tests/test_torch_dist_train.py on fai_mf (JAX's points and attention masks carried): the 2-rank dp
step against JAX's single-device step and against one process, fsdp
against dp, and the two planted faults that must fail the gate."""

import pytest
from test_torch_dist_train import (_family_results, check_fsdp_matches_dp, check_matches_jax,
                                   check_matches_one_process, check_planted_faults_fail, few_threads)  # noqa: F401

FAMILIES = ("fai_mf",)


@pytest.fixture(scope="module")
def results():
    return _family_results(FAMILIES)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_dp_step_matches_jax(results, family):
    check_matches_jax(results, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_dp_step_matches_one_process(results, family):
    check_matches_one_process(results, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_fsdp_step_matches_dp(results, family):
    check_fsdp_matches_dp(results, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_planted_faults_fail_the_gate(results, family):
    check_planted_faults_fail(results, family)
