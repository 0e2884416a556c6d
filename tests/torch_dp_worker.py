"""One rank of the port's data-parallel ``Trainer`` on the CPU (gloo), for
``tests/test_torch_data_parallel.py``.

    python tests/torch_dp_worker.py SETUP RANK WORLD PORT OUT
    python -m torch.distributed.run ... tests/torch_dp_worker.py cli ARGS

``SETUP`` (``torch.save``) holds the hyper-parameters, the corpus root, the
initial weights, the train sampler's state and the JAX ``Trainer``'s draws
(each step's teacher flags, the per-shard decoder seeds JAX folds in, the
evaluation's seeds and the logged sample), so that this process imports no
JAX.  The rank trains one epoch, evaluates and saves (rank 0 logs and
writes), then writes its state, Adam moments, eval loss, MCDs and
checkpoint path to ``OUT/rank{RANK}.pt``.  With ``cli`` it is one rank of
``cli/train.py`` (TensorBoard blocked: its import loads TensorFlow).
"""

import datetime
import os
import sys

import torch
import torch.distributed as dist


class ReplayDraws:
    """The recorded draws, in the order the trainer asks for them."""

    def __init__(self, rec):
        self._train = iter(rec["train"])
        self._eval = iter(rec["eval"])
        self._picks = iter(rec["pick"])
        self._shards = rec["shards"]

    def train(self, frames, ratio):
        teacher, seeds, f, r = next(self._train)
        assert (frames, ratio) == (f, r), ((frames, ratio), (f, r))
        return teacher, seeds

    def eval(self):
        return next(self._eval)

    def pick(self, n):
        idx, m = next(self._picks)
        assert n == m, (n, m)
        return idx

    def shard_seeds(self, seeds, index):
        return self._shards[(tuple(seeds), index)]


def main(setup_path, rank, world, port, out):
    sys.modules["torch.utils.tensorboard"] = None
    torch.set_num_threads(2)
    from multilingual_text_to_speech_tpu_torch.config import HParams
    from multilingual_text_to_speech_tpu_torch.data import (
        TextToSpeechDatasetCollection,
    )
    from multilingual_text_to_speech_tpu_torch.models.layers import (
        ConvBlockGenerated,
    )
    from multilingual_text_to_speech_tpu_torch.ops import audio
    from multilingual_text_to_speech_tpu_torch.parallel import make_mesh
    from multilingual_text_to_speech_tpu_torch.training.trainer import Trainer

    setup = torch.load(setup_path, weights_only=False)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=120))
    mcds = []
    inner = audio.mel_cepstral_distortion

    def mcd(*a, **kw):
        mcds.append(inner(*a, **kw))
        return mcds[-1]
    audio.mel_cepstral_distortion = mcd

    hp = HParams.from_state_dict(setup["hp"])
    tr = Trainer(hp, TextToSpeechDatasetCollection(setup["root"], hp,
                                                   device="cpu"),
                 seed=0, initial_state=setup["init"],
                 draws=ReplayDraws(setup["draws"]),
                 mesh=make_mesh(hp, device="cpu"),
                 log_dir=os.path.join(out, "logs"),
                 checkpoint_dir=os.path.join(out, "ckpt"))
    for m in tr.model.modules():
        if isinstance(m, ConvBlockGenerated):
            m.dropout = 0.0
    tr.train_sampler._rng.set_state(setup["sampler_state"])
    steps = tr.train_epoch()
    eval_loss = tr.evaluate()
    path = tr.save(eval_loss)
    if tr.logger is not None:
        tr.logger.close()
    names = {id(p): n for n, p in tr.model.named_parameters()}
    torch.save({
        "steps": steps, "step": tr.step, "eval_loss": eval_loss,
        "mcds": mcds, "path": path, "logs": tr.logger is not None,
        "state": tr.model.state_dict(),
        "moments": {names[id(p)]: st for p, st in tr.optimizer.state.items()},
    }, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        sys.modules["torch.utils.tensorboard"] = None
        from multilingual_text_to_speech_tpu_torch.cli import train

        train.main(sys.argv[2:])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
             int(sys.argv[4]), sys.argv[5])
