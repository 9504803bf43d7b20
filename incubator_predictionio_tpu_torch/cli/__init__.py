"""The ``pio`` command line of the port (reference: tools/.../console/
Console.scala): ``python -m incubator_predictionio_tpu_torch.cli.main``."""
