"""The short horizon of ``test_torch_paper_tables.py`` for the row kinds
beyond fig4's: QR ``add`` and ``concat``, feature-generation mode, 2 and
60 collisions, thresholds 200 and 20,000 (mixed full/QR table sets) and
the path-based tables.  On the reference's parameters and batches, the
port's training and held-out helpers give the reference's held-out BCE
and accuracy within rtol 1e-5 after ``SHORT_STEPS`` steps.
"""

import numpy as np
import pytest

from test_torch_paper_tables import RTOL, short_horizon


@pytest.mark.parametrize("name", ["fig5/dlrm/add/c4", "fig5/dlrm/concat/c4",
                                  "fig5/dlrm/feature/c4", "fig5/dlrm/mult/c2",
                                  "fig5/dlrm/mult/c60", "fig6/dlrm/qr_mult/thr200",
                                  "fig6/dlrm/qr_mult/thr20000", "table1/dlrm/path/h16"])
def test_short_horizon_matches_reference(name):
    ref, port = short_horizon(name)
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0)
