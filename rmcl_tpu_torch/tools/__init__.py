"""Command-line entry points: the reference's executable layer.

Counterpart of ``rmcl_tpu.tools``. Each reference app (the
micp_localization and rmcl_localization nodes, the conversion nodes, the
map-segmentation nodes) is a ``python -m rmcl_tpu_torch.tools.<name>``
program driven by a YAML config (``config.tree.ParamTree``) and an NPZ
message log (``io.replay.MessageLog``, the JAX package's layout) instead of
DDS topics and TF. Each runs on the card unless ``--device cpu`` says
otherwise:

    python -m rmcl_tpu_torch.tools.micp_localization --map world.obj \\
        --log run.npz --config micp.yaml --out track.npz
    python -m rmcl_tpu_torch.tools.rmcl_localization --map world.obj \\
        --log run.npz --global-box -5 -5 0 -3.14 0 0  5 5 2 3.14 0 0
    python -m rmcl_tpu_torch.tools.map_segmentation --map world.obj --log run.npz
    python -m rmcl_tpu_torch.tools.convert --log run.npz --to scan --out run_scan.npz
"""
