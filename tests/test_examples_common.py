"""examples/_common.py: the coarse preconditioner is chosen by material."""

import os
import sys

import numpy as np
import pytest

from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.materials import SVK, MooneyRivlin, lame_from_E_nu
from tlfea.solvers import System
from tlfea.solvers.coarse import CoarsePrecond
from tlfea.utils.tetmesh import box_t10_mesh

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

from _common import _auto_coarse  # noqa: E402


@pytest.mark.parametrize("material", ["svk", "mooney_rivlin"])
def test_auto_coarse_follows_the_material(material):
    nodes, conn = box_t10_mesh(1.0, 0.2, 0.2, 4, 1, 1)
    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = (SVK(lam=lam, mu=mu) if material == "svk"
           else MooneyRivlin(mu10=2e5, mu01=5e4, kappa=1e6))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = System(elems=feat10.build(nodes, conn, rho=1000.0), material=mat,
                    constraints=FixedCoefs.from_indices(fixed, nodes))
    coarse = _auto_coarse(system, 1e-3, 1e7)
    if material == "svk":
        assert isinstance(coarse, CoarsePrecond)
    else:
        assert coarse is None
