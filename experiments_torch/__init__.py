"""The paper's figure and table experiments on the PyTorch / CUDA port.

One module per script of the JAX package's ``benchmarks/`` folder, named
after it (``fig3d_weight_impl``, ``fig5b_snl``, ``fig6c_nlq``,
``fig7_ima``, ``fig8_accuracy``, ``fig9_energy``, ``table1_comparison``,
``latency_kwn``, ``ablation_k_sweep``, ``ablation_kwn_lm``), each
``run()`` returning the keys of its counterpart, computed by
``repro_torch``.  Run them all with

    PYTHONPATH=src python -m experiments_torch.run [--only NAME] [--device cpu]
"""
