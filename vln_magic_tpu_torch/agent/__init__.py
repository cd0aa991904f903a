from .serving import (Candidate, NavDecision, NavFleet, NavServer,
                      NavSession, Observation, observation_from_world)
