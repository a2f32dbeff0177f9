"""Each package of the port exports what its dsen2_tpu counterpart exports,
apart from the names listed here as not ported (or JAX-only), which the test
prints."""

import importlib

import pytest

# dsen2_tpu names the port does not export, and why.
NOT_PORTED = {
    "": {},
    "core": {},
    "data": {
        "interp_patches_host": "archive writers wait for create_patches (ROADMAP A13)",
        "save_random_patches": "ROADMAP A13",
        "save_random_patches60": "ROADMAP A13",
        "save_test_patches": "ROADMAP A13",
        "save_test_patches60": "ROADMAP A13",
    },
    "infer": {"sr_pipeline": "JAX-only: jax.jit of sr_tile; the port's sr_tile runs eagerly"},
    "ops": {"recompose": "ROADMAP A11"},
    "train": {
        "nadam_keras": "optax transformation; the port's is make_optimizer (torch.optim.NAdam)",
        "NadamKerasState": "optax state; the port keeps the optimizer's state_dict",
    },
    "weights": {},
}
PACKAGES_NOT_PORTED = {"parallel": "ROADMAP A12", "io": "ROADMAP A11", "geo": "ROADMAP A11",
                       "refimpl": "numpy oracles for tests; tests import them"}


@pytest.mark.parametrize("pkg", sorted(NOT_PORTED))
def test_exports_match_the_jax_package(pkg):
    jmod = importlib.import_module("dsen2_tpu" + (f".{pkg}" if pkg else ""))
    tmod = importlib.import_module("dsen2_tpu_torch" + (f".{pkg}" if pkg else ""))
    missing = set(jmod.__all__) - set(tmod.__all__)
    print(f"{pkg or 'dsen2_tpu'}: not ported {sorted(NOT_PORTED[pkg]) or 'none'}")
    assert missing == set(NOT_PORTED[pkg])
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name


def test_unported_packages_are_listed():
    for name in PACKAGES_NOT_PORTED:
        importlib.import_module(f"dsen2_tpu.{name}")
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"dsen2_tpu_torch.{name}")
    print(f"packages not ported: {PACKAGES_NOT_PORTED}")


def test_importing_ops_builds_no_kernel():
    from dsen2_tpu_torch.ops import _build

    importlib.import_module("dsen2_tpu_torch.ops")
    assert _build._lib is None and not _build.build_log
