"""Core of the port: the Gamma helpers (:mod:`.prefix`) and the device
partitioners (:mod:`.device`)."""
