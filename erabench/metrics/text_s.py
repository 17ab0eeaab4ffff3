"""text_s (s): the text layer (``api._device_text`` -> ``packing.pack_text``
on a dense alphabet, ``Alphabet.pad_string`` on bytes): the construction
text made on the host and copied to the device, ``BuildReport.t_text``
per build, the interval of the program's ``build/text`` span.  A program
without that timer reports nothing."""

from erabench.metrics._per_build import mean


def read(run):
    if not run.builds or not hasattr(run.builds[0].record["report"],
                                     "t_text"):
        return None
    return mean(run, lambda b: b.record["report"].t_text)
