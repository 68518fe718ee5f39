"""Goodput of the checkpointing cell: tokens of completed train steps over
the whole window, take stalls inside it (host clock). A metric of its
own, apart from the train cells' ``goodput_tokens_per_s``, so that each
has a bound that fits its spread."""

from portbench.harness import metric_reader

read = metric_reader("goodput_tokens_per_s")
