"""Port parity for the P6 families of the model zoo (4 output levels, the
4-level head at strides 8-64): EfficientRep6 with RepBiFPANNeck6 (yolov6n6)
and with RepPANNeck6, CSPBepBackbone_P6 with CSPRepBiFPANNeck_P6 (yolov6m6,
and yolov6l6 in the conv_silu mode) and with CSPRepPANNeck_P6, narrow, at
128 px, held as
tests/test_torch_zoo.py holds the P5 families."""

import pytest

import conftest  # noqa: F401  (forces the JAX cpu backend)
from test_torch_zoo import FAMILIES, check_family


@pytest.mark.parametrize("family", ["yolov6n6", "yolov6m6", "yolov6l6", "RepPANNeck6",
                                    "CSPRepPANNeck_P6"])
def test_p6_family_matches_flax(family):
    check_family(*FAMILIES[family])
