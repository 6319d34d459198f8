"""The example apps on the port: the reference's test apps over
``opt_tpu_torch.harness`` and ``opt_tpu_torch.utils.io``.

Each app is a module run as ``python -m opt_tpu_torch.examples.<app>
[--small] [--cpu] ...``, with the flags, defaults and printed lines of the
JAX package's ``examples/<app>.py``; ``main(argv)`` runs it in-process.
The apps run on the card unless ``--cpu`` asks for the CPU, and write
their images and meshes into the current directory, their CSVs under
``--results``. They read the reference's example data from the directory
that ``OPT_TPU_EXAMPLE_DATA`` names; where it is unset or lacks a file
they solve the same synthetic problems as the JAX apps. Nothing is
downloaded.
"""
