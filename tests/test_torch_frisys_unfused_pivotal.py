"""The port's pivotal frisys spawner with its unfused stages against the
reference package: ``fuse_ab=False`` with unnormed weights and
``fuse_cd=False`` with normed ones, fed the reference's key
(``jax_keys.JaxKeys``): keys exact, amplitudes within rtol 1e-12
(``test_torch_frisys_unfused.py`` holds the systematic spawner and
steps)."""

import pytest

pytest.importorskip("torch")

from test_torch_frisys_unfused import arena_input, spawner_matches_reference  # noqa: E402,F401


@pytest.mark.parametrize("stages,unnorm", [("ab", True), ("cd", False)])
def test_unfused_pivotal_spawner_matches_reference(arena_input, stages, unnorm):  # noqa: F811
    spawner_matches_reference(arena_input, stages, True, unnorm)
