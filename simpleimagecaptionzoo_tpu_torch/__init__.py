"""simpleimagecaptionzoo_tpu_torch — the captioning stack in PyTorch for an
NVIDIA Hopper GPU.

A port of ``simpleimagecaptionzoo_tpu`` (JAX on a TPU), which stays beside it
as the reference each part is held against.  The port imports ``torch`` and
numpy only: nothing of JAX and nothing of the JAX package.  Every Pallas
kernel of the JAX package becomes a CUDA C++ kernel written for ``sm_90a``
(``csrc/``), built at first use (``ops/_build.py``) and launched through a
wrapper that keeps a plain PyTorch version of the same function beside it for
CPU tensors.

What is ported so far: AoADetection greedy decode
(``engine.steps.make_greedy_decode``) through the fused prediction-head top-k
kernel (``ops/fused_head.py``) and the fused LSTM cell forward
(``ops/fused_lstm.py``); and its int8 serving form
(``model.quantize_decode_params``) through the int8 dequantizing product
(``ops/quant.py``), the fused head over int8 weights and, with
``SICZ_TPU_INT8_KV`` on, the int8 K/V attention (``ops/int8_attention.py``);
beam search (``engine.steps.make_beam_decode``) of the same; both
decodes of BUTDDetection, BUTDSpatial (``models/butd.py``), NIC
(``models/nic.py``) and AoASpatial in feature mode, in float32, bf16 and
int8 serving form; and XE training of AoADetection
(``engine.steps.make_xe_train_step``, ``make_xe_eval_loss``; the
optimizers in ``engine/optim.py``, the state in ``engine/state.py``, the
loss in ``ops/losses.py``, teacher forcing with scheduled sampling in
``ops/decode.py``), the LSTM cell's gradient through the backward kernel
of ``ops/fused_lstm.py`` (an autograd Function), in float32 and in bf16
over float32 master weights; the same XE training for the other four
families; and SCST training of all five
(``engine.steps.make_scst_train_step``: a greedy baseline, the rollout
``ops/decode.sample_rl``, the CIDEr-D reward on the card, ``ops/cider.py``,
and ``ops/losses.reward_criterion``).  Around the models: the CLI
(``python -m simpleimagecaptionzoo_tpu_torch.main --operation
{train,scst_train,eval,sample}``, the JAX package's flags), the engine that
runs the epochs, evaluations and samples (``engine/engine.py``,
``model_engines.py``, ``sample.py``, ``observe.py``), the data layer
(``data/``), checkpoints in the JAX package's flax msgpack layout, read
and written without flax (``engine/checkpoint.py``), and the COCO-caption
scorers (``evalcap/``).  ``ROADMAP.md`` lists what follows.

Token id conventions follow the reference (Build_caption_vocab.py:37-40):
``<pad>``=0, ``<sta>``=1, ``<end>``=2, ``<unk>``=3.  Importing the package has
no side effects.
"""

__version__ = "0.1.0"

PAD_ID = 0
STA_ID = 1
END_ID = 2
UNK_ID = 3
