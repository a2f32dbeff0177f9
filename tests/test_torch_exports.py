"""Each package of the port exports what its dsen2_tpu counterpart exports,
apart from the JAX-only names listed here, and each dsen2_tpu module has a
counterpart at the same path in the port, apart from the packages listed as
not ported (or JAX-only). The test prints both lists."""

import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# dsen2_tpu names the port does not export, and why.
NOT_PORTED = {
    "": {},
    "core": {},
    "data": {},
    "geo": {},
    "infer": {},
    "ops": {},
    "parallel": {},
    "train": {},
    "weights": {},
}
# dsen2_tpu names that belong to JAX and have another form in the port.
JAX_ONLY = {
    "infer": {"sr_pipeline": "jax.jit of sr_tile; the port's sr_tile runs eagerly"},
    "train": {
        "nadam_keras": "optax transformation; the port's is make_optimizer (torch.optim.NAdam)",
        "NadamKerasState": "optax state; the port keeps the optimizer's state_dict",
    },
}
PACKAGES_NOT_PORTED: dict = {}
# dsen2_tpu sub-packages that have another form in the port, or none.
JAX_ONLY_PACKAGES = {
    "refimpl": "numpy oracles for tests; tests import them",
    "ops/pallas": "the TPU kernels; the port's are ops/resblock*.py over csrc/resblock_chain.cu",
}


@pytest.mark.parametrize("pkg", sorted(NOT_PORTED))
def test_exports_match_the_jax_package(pkg):
    jmod = importlib.import_module("dsen2_tpu" + (f".{pkg}" if pkg else ""))
    tmod = importlib.import_module("dsen2_tpu_torch" + (f".{pkg}" if pkg else ""))
    missing = set(jmod.__all__) - set(tmod.__all__)
    jax_only = JAX_ONLY.get(pkg, {})
    print(f"{pkg or 'dsen2_tpu'}: not ported {sorted(NOT_PORTED[pkg]) or 'none'}, "
          f"JAX-only {sorted(jax_only) or 'none'}")
    assert missing == set(NOT_PORTED[pkg]) | set(jax_only)
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name


def test_unported_packages_are_listed():
    for name in PACKAGES_NOT_PORTED:
        importlib.import_module(f"dsen2_tpu.{name}")
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"dsen2_tpu_torch.{name}")
    unmatched = []
    for root, _, names in os.walk(os.path.join(REPO, "dsen2_tpu")):
        for n in names:
            rel = os.path.relpath(os.path.join(root, n), os.path.join(REPO, "dsen2_tpu"))
            if n.endswith(".py") and not os.path.isfile(os.path.join(REPO, "dsen2_tpu_torch", rel)):
                unmatched.append(rel)
    skip = tuple(p + os.sep for p in list(PACKAGES_NOT_PORTED) + list(JAX_ONLY_PACKAGES))
    assert [rel for rel in unmatched if not rel.startswith(skip)] == []
    print(f"packages not ported: {PACKAGES_NOT_PORTED}; JAX-only: {JAX_ONLY_PACKAGES}")


def test_importing_ops_builds_no_kernel():
    from dsen2_tpu_torch.ops import _build

    importlib.import_module("dsen2_tpu_torch.ops")
    assert not _build._libs and not _build.build_log
