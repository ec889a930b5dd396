"""`render_bands` over 8 bands against JAX `rasterize_tile_sharded` on
`make_mesh(8)`, with the span staircase in every band (the check is
test_torch_port_sharded.py's; the JAX side compiles for ~35 s, so each
world has a file of its own)."""

from test_torch_port_sharded import check_bands_match_jax


def test_bands_match_jax_sharded_8(rng):
    check_bands_match_jax(rng, 8)
