"""The second half of the pattern corpus's device cases through both
packages' ``DeviceNFARuntime``s (``test_torch_nfa_corpus.py`` runs the first
half and says what is compared); split so each file stays short on one test
worker."""

import pytest

from test_torch_nfa_corpus import check_runtime_rows, device_cases


@pytest.mark.parametrize("app,seq", device_cases(1))
def test_runtime_rows_match_jax(app, seq):
    check_runtime_rows(app, seq)
