"""Multi-process training and serving on ``torch.distributed``.

Counterpart of ``medical_image_analysis_tpu/parallel/`` (``mesh.py``,
``tp.py``, ``sp_scan.py``), keeping its names: a (data, model) grid of
ranks (:mod:`.mesh`), Megatron tensor parallelism of the LLM over the
``model`` axis (:mod:`.tp`) and the sequence-parallel selective scan
(:mod:`.sp_scan`). The sharded train step (data parallelism, ZeRO-1 and
accumulation) is ``train/train_state.py``'s ``make_train_step``.
"""
