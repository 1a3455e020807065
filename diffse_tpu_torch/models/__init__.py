"""Models: NCSN++ score network and the ScoreModel orchestrator."""
