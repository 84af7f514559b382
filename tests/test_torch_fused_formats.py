"""The port's fused chain against the JAX package's `_chain` on the
chroma-format (4:2:2, 4:4:4, 4:0:0 with LMCS) and CTU-64 streams of
test_fused_chain_formats (see test_torch_fused.py)."""
import pytest

from test_torch_fused import check_chain_matches_jax


@pytest.mark.parametrize("name", ["p_422", "p_444", "mono_lmcs", "ctu64"])
def test_chain_matches_jax_formats(name, monkeypatch):
    check_chain_matches_jax(name, monkeypatch)
