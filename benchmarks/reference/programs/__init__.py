"""One module per program family a configuration can name (its
``program.family``): the MASM source the port assembles, the program's
digest worked out from its own op list, and the stack outputs its execution
must give, each computed here without the port."""
