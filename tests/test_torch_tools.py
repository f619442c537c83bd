"""``tools/hist_card_vs_cpu.py``'s references, on the CPU.

``chip_smoke.py``'s phase 9 and ``tests/test_torch_cuda.py`` hold the
history model on the card against the CPU model fed the card's mean
log M*; here the feeding itself is checked, with a second CPU data set in
the card's place: the fed model's forward is exactly the other data's,
and fed its own it is exactly itself.
"""
import numpy as np

from multigrad_tpu_torch.models import GalhaloHistModel, make_galhalo_hist_data
from multigrad_tpu_torch.models import galhalo_hist as th
from tools.hist_card_vs_cpu import evaluate, evaluate_fed, gaps

PARAMS = np.array(th.TRUTH, np.float32) + 0.05


def test_fed_history_takes_the_given_forward():
    aux = make_galhalo_hist_data(4_000, chunk_size=1_000, device="cpu")
    other = dict(aux, time_grid=aux["time_grid"] * 1.001)
    model = GalhaloHistModel(aux_data=aux)
    block = th._mean_log_mstar_block

    fed = evaluate_fed(model, other, PARAMS)
    want = evaluate(GalhaloHistModel(aux_data=other), PARAMS)
    own = evaluate(model, PARAMS)
    np.testing.assert_array_equal(fed[0], want[0])
    assert fed[1] == want[1]
    assert gaps(fed, own)["y_rtol"] > 1e-3      # not the model's own

    same = evaluate_fed(model, aux, PARAMS)
    for a, b in zip(same, own):
        np.testing.assert_array_equal(a, b)
    assert gaps(same, own) == dict(y_rtol=0.0, loss_rel=0.0, grad_rtol=0.0)
    assert th._mean_log_mstar_block is block    # the model is restored
