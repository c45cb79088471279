"""The port's HF causal-LM trial (``model_hub/huggingface.py``, over
transformers' PyTorch GPT-2) held against the JAX package's Flax trial
of ``tests/test_model_hub.py``.

The Flax trial's initial weights (``from_config``, seed 0) are converted
into the PyTorch model with transformers' own Flax → PyTorch loader, and
the port's trial starts from them. Dropout is off in this config (each
framework draws its own masks). Then, in fp32 on the CPU:

- ``lm_batches`` is the same, array for array;
- the loss and perplexity of one batch, train and eval mode, agree to
  2e-5 relative;
- both trials through their ``Trainer.fit`` for 6 batches (AdamW, a
  2-step warmup): every training report's loss and the validation loss
  agree to 2e-4 relative (fp32 rounding compounding over the updates;
  the first step agrees to 2e-5);
- with dropout on, the port's loss is the same for the same step seed
  and differs for another.

This runs here only: transformers is not recorded on the card's
machine, so no card phase runs it.
"""
import contextlib

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
import jax  # noqa: E402
import torch  # noqa: E402

from determined_clone_tpu import core as jcore  # noqa: E402
from determined_clone_tpu.config import ExperimentConfig as JConfig  # noqa: E402,E501
from determined_clone_tpu.model_hub import HFCausalLMTrial as JHFTrial  # noqa: E402,E501
from determined_clone_tpu.model_hub import lm_batches as jlm  # noqa: E402
from determined_clone_tpu.training import Trainer as JTrainer  # noqa: E402
from determined_clone_tpu.training import TrialContext as JContext  # noqa: E402,E501
from determined_clone_tpu_torch import core as tcore  # noqa: E402
from determined_clone_tpu_torch.config import ExperimentConfig as TConfig  # noqa: E402,E501
from determined_clone_tpu_torch.model_hub import HFCausalLMTrial as THFTrial  # noqa: E402,E501
from determined_clone_tpu_torch.model_hub import lm_batches as tlm  # noqa: E402,E501
from determined_clone_tpu_torch.training import Trainer as TTrainer  # noqa: E402,E501
from determined_clone_tpu_torch.training import TrialContext as TContext  # noqa: E402,E501

torch.set_num_threads(1)
RTOL_STEP, RTOL_FIT = 2e-5, 2e-4


def gpt2_config(dropout=0.0):
    return transformers.GPT2Config(
        n_layer=2, n_embd=32, n_head=2, vocab_size=64, n_positions=32,
        resid_pdrop=dropout, embd_pdrop=dropout, attn_pdrop=dropout)


def data(trial, seed, n):
    tokens = np.random.RandomState(seed).randint(0, 64, size=n)
    return lm_batches_of(trial)(tokens, trial.global_batch_size, seq_len=16)


def lm_batches_of(trial):
    return jlm if isinstance(trial, JHFTrial) else tlm


class Data:
    def training_data(self):
        yield from data(self, 0, 4096)

    def validation_data(self):
        return list(data(self, 1, 512))

    @property
    def global_batch_size(self):
        return 4


class JTrial(Data, JHFTrial):
    def model_config(self):
        return gpt2_config()


class TTrial(Data, THFTrial):
    flax_params = None

    def model_config(self):
        return gpt2_config()

    def initial_params(self, gen):
        params = super().initial_params(gen)
        # the Flax trial's weights, through transformers' own converter
        from transformers.modeling_flax_pytorch_utils import (
            load_flax_weights_in_pytorch_model,
        )

        load_flax_weights_in_pytorch_model(self._model, self.flax_params)
        return params


@pytest.fixture(scope="module")
def flax_params():
    return jax.device_get(transformers.FlaxAutoModelForCausalLM.from_config(
        gpt2_config()).params)


@pytest.mark.parametrize("seed,bs,seq", [(0, 3, 8), (1, 4, 16), (2, 1, 5)])
def test_lm_batches_as_jax(seed, bs, seq):
    tokens = np.random.RandomState(seed).randint(0, 1000, size=700)
    j, t = list(jlm(tokens, bs, seq)), list(tlm(tokens, bs, seq))
    assert len(t) == len(j) > 0
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.int32 and b.shape == (bs, seq + 1)


CONFIG = {"searcher": {"name": "single", "metric": "loss",
                       "max_length": {"batches": 6}},
          "scheduling_unit": 3, "resources": {"slots_per_trial": 1}}
HP = {"learning_rate": 1e-3, "warmup_steps": 2}


def _trials(tmp_path, flax_params):
    jcfg, tcfg = JConfig.from_dict(CONFIG), TConfig.from_dict(CONFIG)
    stack = contextlib.ExitStack()
    jctx = stack.enter_context(jcore.init(config=jcfg,
                                          storage_path=str(tmp_path / "j")))
    tctx = stack.enter_context(tcore.init(config=tcfg,
                                          storage_path=str(tmp_path / "t")))
    jt = JTrial(JContext(config=jcfg, hparams=HP, core=jctx))
    TTrial.flax_params = flax_params
    tt = TTrial(TContext(config=tcfg, hparams=HP, core=tctx, device="cpu"))
    return stack, jt, tt


def test_one_batch_loss_as_jax(tmp_path, flax_params):
    stack, jt, tt = _trials(tmp_path, flax_params)
    with stack:
        jp = jt.initial_params(jax.random.PRNGKey(0))
        tp = tt.initial_params(torch.Generator().manual_seed(0))
        batch = next(iter(jt.training_data()))
        jl, jm = jt.loss(jp, batch, jax.random.PRNGKey(1))
        tl, tm = tt.loss(tp, batch, 1)
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL_STEP)
        np.testing.assert_allclose(float(tm["perplexity"]),
                                   float(jm["perplexity"]), rtol=RTOL_STEP)
        je, te = jt.eval_metrics(jp, batch), tt.eval_metrics(tp, batch)
        np.testing.assert_allclose(float(te["loss"]), float(je["loss"]),
                                   rtol=RTOL_STEP)
        # the trial's parameters are the module's own tensors: one copy
        assert all(p.data_ptr() == tp[n].data_ptr()
                   for n, p in tt.model.named_parameters())


def test_trainers_fit_as_jax(tmp_path, flax_params):
    stack, jt, tt = _trials(tmp_path, flax_params)
    with stack:
        jres = JTrainer(jt).fit()
        jrec = list(jt.context.core.train._backend.records)
        tres = TTrainer(tt).fit()
        trec = list(tt.context.core.train._backend.records)
    assert tres["batches_trained"] == jres["batches_trained"] == 6

    def losses(records):
        return [r["metrics"]["loss"] for r in records
                if r["group"] == "training"]

    assert len(losses(trec)) == len(losses(jrec)) == 2
    np.testing.assert_allclose(losses(trec), losses(jrec), rtol=RTOL_FIT)
    tv, jv = tres["last_validation"], jres["last_validation"]
    np.testing.assert_allclose([tv["loss"], tv["perplexity"]],
                               [jv["loss"], jv["perplexity"]],
                               rtol=RTOL_FIT)
    assert tv["loss"] < 4.5  # from ~ln(64), as the JAX test asks


def test_dropout_follows_the_step_seed(tmp_path):
    class Drop(Data, THFTrial):
        def model_config(self):
            return gpt2_config(dropout=0.3)

    cfg = TConfig.from_dict(CONFIG)
    with tcore.init(config=cfg, storage_path=str(tmp_path)) as ctx:
        trial = Drop(TContext(config=cfg, hparams=HP, core=ctx,
                              device="cpu"))
        params = trial.initial_params(torch.Generator().manual_seed(0))
        batch = next(iter(trial.training_data()))
        a, b = (float(trial.loss(params, batch, s)[0]) for s in (5, 5))
        c = float(trial.loss(params, batch, 6)[0])
        e1 = float(trial.eval_metrics(params, batch)["loss"])
        e2 = float(trial.eval_metrics(params, batch, 9)["loss"])
    assert a == b and a != c and e1 == e2


def test_package_imports_without_transformers():
    """The port's hub module imports transformers only to build a model."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['transformers'] = None\n"
            "import determined_clone_tpu_torch.model_hub as m\n"
            "assert m.HFCausalLMTrial and m.lm_batches\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
