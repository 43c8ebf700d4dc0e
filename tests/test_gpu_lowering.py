"""Chip-free GPU lowering check for the production sketch step.

The CPU suite runs the packed kernel in interpret mode, which skips the
Triton lowering entirely. JAX's AOT path lowers for the CUDA platform on
any host: it serializes the Pallas kernel to Triton IR and lowers the
whole step to HLO without a device, catching grid, shape, dtype and
unsupported-primitive errors. The Triton backend compile itself (register
and shared-memory limits) still needs the card (the `gpu`-marked tests).
"""

import numpy as np
import pytest

from hypergen_tpu.models.sketcher import Sketcher, packed_row_words
from hypergen_tpu.params import SketchParams

PROD_NC = 32  # the 4.19 Mbp production bucket


@pytest.mark.parametrize("method", ["t1ha2", "mmhash"])
def test_packed_step_lowers_for_gpu(method):
    p = SketchParams(sketch_method=method)
    sk = Sketcher(p, packed=True)
    assert sk.packed_mode
    sk.interpret = False  # lower the kernel as the GPU compiles it
    step, cap, enc_cap, be_cap = sk._get_step(PROD_NC, validity="packed")
    B, C = sk.batch, sk.C
    W = packed_row_words(PROD_NC, C)
    pw = np.zeros((B, W), np.uint32)
    runs = np.full((B, sk.run_cap, 2), np.int32(0x7FFFFFFF), np.int32)
    n_pos = np.full(B, PROD_NC * C, np.int32)
    lowered = step.trace(pw, runs, n_pos).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    # the fused kernel must be in there as a Triton custom call
    assert "__gpu$xla.gpu.triton" in text
    assert "hg_packed_sketch" in text
