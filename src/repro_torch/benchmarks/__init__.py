"""The paper's FPGA tables and the DSE sweep, on the port's FPGA model.

Port copies of the reference's ``benchmarks/table1.py``, ``table2.py`` and
``dse_sweep.py``; each ``run()`` returns the reference's rows and each
``main()`` prints its text (``tests/test_torch_fpga.py``).  Run as
``python -m repro_torch.benchmarks.table1`` (``table2``, ``dse_sweep``).
"""
