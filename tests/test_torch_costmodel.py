"""The port's ``launch/costmodel.py``, a verbatim copy of the reference's
(``tests/test_torch_isolation.py`` holds the source), gives the
reference's numbers: ``analytic_cost`` of every registered arch at every
shape ``shape_applicable`` allows, on 1 and 256 devices, under the
default remat and none, exactly (the same Python arithmetic over the
same config fields).  The encoder–decoder's branches are
seamless-m4t-medium's.
"""
from __future__ import annotations

import dataclasses

import pytest

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import list_archs as j_list_archs
from repro.configs.base import shape_applicable as j_shape_applicable
from repro.launch import costmodel as j_costmodel
from repro.models.lm import RunConfig as JRunConfig
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.launch import costmodel
from repro_torch.models.lm import RunConfig

CELLS = [(arch, shape) for arch in j_list_archs() for shape in J_SHAPES
         if j_shape_applicable(j_get_arch(arch), J_SHAPES[shape])[0]]


def test_cells_cover_the_encoder_decoder():
    assert any(j_get_arch(arch).enc_dec for arch, _ in CELLS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_cost_equals_the_reference(arch, shape):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    for n_devices in (1, 256):
        for remat in ("full", "none"):
            got = costmodel.analytic_cost(cfg, SHAPES[shape], n_devices,
                                          RunConfig(remat=remat))
            want = j_costmodel.analytic_cost(jcfg, J_SHAPES[shape],
                                             n_devices,
                                             JRunConfig(remat=remat))
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert costmodel.attention_flops(cfg, SHAPES[shape]) \
        == j_costmodel.attention_flops(jcfg, J_SHAPES[shape])
