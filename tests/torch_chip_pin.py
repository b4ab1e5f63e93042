"""One chip record for both packages in the port's CPU parity tests.

Each package resolves its chip record at first use: the file that
``CUEMBED_CHIP_CONSTANTS`` names, else the attached device's committed
record, else the v5e fallback. On a machine with an NVIDIA card the port
would take the card's record while the JAX package, on the CPU, takes the
fallback, and a case that sizes a configuration from the record would
compare two different records. ``one_chip_record``, imported into a test
module, makes both packages read one record in every case of the module,
spawned ranks included (they inherit the environment): the file
``CUEMBED_CHIP_CONSTANTS`` names where it is set, else a record of no
measurements, from which both derive the fallback. It resets both
packages' caches before and after the module.
"""

from __future__ import annotations

import json
import os

import pytest


def _reset_both():
    from cuembed_tpu.utils import chip as jchip
    from cuembed_tpu_torch.utils import chip as tchip

    tchip._reset_cache_for_tests()
    jchip._reset_cache_for_tests()


@pytest.fixture(scope="module", autouse=True)
def one_chip_record(tmp_path_factory):
    from cuembed_tpu_torch.utils.chip import V5E_DEFAULTS

    with pytest.MonkeyPatch.context() as mp:
        if not os.environ.get("CUEMBED_CHIP_CONSTANTS"):
            path = tmp_path_factory.mktemp("chip_record") / "fallback.json"
            path.write_text(json.dumps({"device_kind": V5E_DEFAULTS["device_kind"]}))
            mp.setenv("CUEMBED_CHIP_CONSTANTS", str(path))
        _reset_both()
        yield
    _reset_both()
