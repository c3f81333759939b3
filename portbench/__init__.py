"""The benchmark of the s2v_torch port (``python3 portbench/run.py``); see
README.md."""
