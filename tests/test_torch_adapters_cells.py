"""Multi-LoRA serving's equivalence cells at k 8 and with prefix caching (a shared 17-token prefix, sent twice): a
mixed batch of base rows and three adapters on one port engine, bf16 and
int8 base, against the JAX multi-adapter engine (greedy tokens exactly,
logprobs within 1e-4), the port's merged-weights engines (greedy and
seeded) and an adapter-off engine (base rows exactly). The cells and their
fixtures are ``tests/torch_adapter_cells.py``'s; ``test_torch_adapters.py``
runs the others.
"""

import pytest

from torch_adapter_cells import _cell, _clean_catalogs, setup  # noqa: F401 (fixtures)

CONFIGS = ('k8', 'prefix')


@pytest.mark.parametrize("config", CONFIGS)
def test_batched_adapters_match_merged_engines_bf16(setup, config):
    """bf16 base weights (float32 compute), three adapters and base rows in
    one batch."""
    _cell(setup, "bf16", config)


@pytest.mark.parametrize("config", CONFIGS)
def test_batched_adapters_match_merged_engines_int8(setup, config):
    """int8 base weights: both engines quantize the same base onto one grid;
    the adapter delta rides outside it."""
    _cell(setup, "int8", config)
