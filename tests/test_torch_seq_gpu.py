"""The sequential family on the card (marked ``gpu``; skipped without a
CUDA card): eval and session serving launch the masked-scoring kernel
(K1) once per batch and agree with the same model on the CPU (metrics
within 1e-6, top-k ids wherever the scores are not tied, scores within
1e-4: K1 sums in another order); 3 training steps with the same host
draws agree with the CPU's within 1e-5 (losses) and 5e-5 (parameters)."""

import numpy as np
import pytest
import torch

from gsrs_tpu_torch.data.sequences import synthetic_markov_sequences
from gsrs_tpu_torch.models.registry import SEQ_MODELS, build_seq_model
from gsrs_tpu_torch.ops import scoring
from gsrs_tpu_torch.serve_seq import SeqRetriever
from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

M, L = 300, 20
DATA = synthetic_markov_sequences(n_users=200, m_items=M, n_clusters=5, max_len=L, seed=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the masked-scoring kernel is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def trainer(kind, device):
    model = build_seq_model(kind, M, max_len=L, dim=32, hidden=32, blocks=2, device=device,
                            generator=torch.Generator().manual_seed(1))
    return SeqTrainer(model, DATA, batch_size=64, eval_batch=64, topks=(10, 100),
                      device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SEQ_MODELS)
def test_steps_and_eval_on_the_card_match_the_cpu(cuda, kind):
    card, cpu = trainer(kind, cuda), trainer(kind, "cpu")
    batches = cpu.epoch_batches(0)[:3]
    g = torch.Generator().manual_seed(7)
    draws = [cpu.draw_step(b, g) for b in batches]
    s_card, l_card = card.run_steps(card.init_state(), batches, draws)
    s_cpu, l_cpu = cpu.run_steps(cpu.init_state(), batches, draws)
    np.testing.assert_allclose(l_card.cpu().numpy(), l_cpu.numpy(), rtol=1e-5, atol=1e-5)
    for k, p in s_cpu.params.items():
        np.testing.assert_allclose(s_card.params[k].detach().cpu().numpy(),
                                   p.detach().numpy(), rtol=0, atol=5e-5, err_msg=k)
    card.model.load_state_dict(cpu.model.state_dict())
    before = scoring.LAUNCHES["masked_scores"]
    on_card = card.evaluate()
    assert scoring.LAUNCHES["masked_scores"] == before + card._eval_seqs.shape[0]
    on_cpu = cpu.evaluate()
    assert on_cpu["recall@100"] > 0
    for k in on_cpu:
        assert abs(on_card[k] - on_cpu[k]) <= 1e-6, (k, on_card[k], on_cpu[k])


@pytest.mark.gpu
def test_session_serving_on_the_card_matches_the_cpu(cuda):
    model = build_seq_model("sasrec", M, max_len=L, dim=32, hidden=32, device="cpu")
    sessions = [[int(i) for i in np.random.default_rng(n).choice(M, n, replace=False)]
                for n in range(1, 70)]
    want_items, want_scores = SeqRetriever(model, batch_size=16, device="cpu").recommend(
        sessions, k=20)
    r = SeqRetriever(model, batch_size=16, device=cuda)
    before = scoring.LAUNCHES["masked_scores"]
    items, scores = r.recommend(sessions, k=20)
    assert scoring.LAUNCHES["masked_scores"] == before + -(-len(sessions) // 16)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-4, atol=1e-4)
    gaps = np.abs(np.diff(want_scores, axis=1))
    untied = np.ones_like(want_scores, dtype=bool)
    untied[:, 1:] &= gaps > 1e-4
    untied[:, :-1] &= gaps > 1e-4
    np.testing.assert_array_equal(items[untied], want_items[untied])
    for sess, row in zip(sessions, items):
        assert not set(row.tolist()) & set(sess)
    with pytest.raises(ValueError, match="out of range"):
        r.recommend([[M]], k=5)
