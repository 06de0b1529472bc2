"""The ``film`` and ``both`` context fusions through the port's plain,
grouped and fused eval paths and with ``regress_mode="lowres"``, against the
JAX model (``test_torch_port_paths.py``'s checks and tolerances, split off so
that the two files' JAX compiles run in two test processes)."""

import pytest

from test_torch_port_paths import (  # noqa: F401
    PATHS,
    PLAIN,
    check_lowres,
    check_option,
    images,
    jax_run,
    one_torch_thread,
)

CASES = {
    "film": dict(context_fusion="film"),
    "both": dict(context_fusion="both"),
}


@pytest.fixture(scope="module", params=list(CASES))
def jax_case(request, images):  # noqa: F811
    return request.param, jax_run(images, **PLAIN, **CASES[request.param])


@pytest.mark.parametrize("path", list(PATHS))
def test_option_matches_jax_on_each_eval_path(images, jax_case, path):  # noqa: F811
    case, result = jax_case
    check_option(CASES[case], images, result, path)


def test_lowres_regression_matches_jax(images, jax_case):  # noqa: F811
    case, result = jax_case
    check_lowres(CASES[case], images, result)
