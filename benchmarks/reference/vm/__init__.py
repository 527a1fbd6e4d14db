"""The Miden VM's part of the reference verifier: its AIRs, the relation
digest that seeds its transcript, program digests, and execution proofs."""
