"""The benchmark's frozen string generator (:mod:`erabench.data.strings`)."""
