"""The resilience layer's typed errors (resilience/errors.py), which the
serving queue and transports raise and map. Checkpoints, resume, fault
injection and heartbeats are not ported (ROADMAP A.11)."""
