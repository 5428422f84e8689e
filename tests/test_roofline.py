"""Published peaks (`tlfea.utils.roofline`): a table keyed by device_kind."""

import pytest

from tlfea.utils.roofline import CHIP_PEAKS, chip_peaks


def test_h100_peaks_from_data_sheet():
    pk = chip_peaks("NVIDIA H100 80GB HBM3")
    assert pk.hbm_bytes_per_s == 3.35e12
    assert pk.bf16_flops == 989e12
    assert pk.fp32_flops == 67e12
    assert "data sheet" in pk.source
    assert set(CHIP_PEAKS) == {"NVIDIA H100 80GB HBM3"}


def test_unknown_device_kind_is_an_error():
    with pytest.raises(KeyError, match="no published peaks"):
        chip_peaks("cpu")
