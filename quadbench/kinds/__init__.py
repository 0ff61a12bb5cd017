"""One module a traffic kind, named as the traffic files name it; each
defines ``KIND``, a subclass of ``quadbench.traffic.Kind``."""
